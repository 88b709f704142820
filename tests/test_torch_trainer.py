"""The PyTorch port's LM ``Trainer`` against the JAX reference's over six
steps from one converted state, the port's restart drill, and
``launch/train.py`` (an LM and ``--distger``) on the CPU.

Tolerances (float32, the reduced qwen3-1.7b): each step's loss and
gradient norm within 1e-5 relative, each parameter leaf within 1e-5 and
each moment leaf within 1e-4 of its largest magnitude (measured 1e-7 on
the parameters: the same float32 formulas, products summed in other
orders); a restarted run against an uninterrupted one bit for bit,
whether the crash comes after a checkpoint or before the first.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import zoo as jax_zoo
from repro.optim.optimizers import AdamWConfig as JaxAdamWConfig
from repro.optim.optimizers import init_opt_state as jax_init_opt_state
from repro.runtime.trainer import Trainer as JaxTrainer
from repro.runtime.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.ckpt.checkpoint import flatten
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_reference, opt_state_from_reference
from repro_torch.optim.optimizers import leaves
from repro_torch.runtime.faults import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEP_RTOL, PARAM_TOL, MOMENT_TOL = 1e-5, 1e-5, 1e-4


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_leaves_close(got: dict, want: dict, tol: float, what: str) -> None:
    """Port trees (``flatten`` paths) against reference trees converted to the
    port's layout: each leaf within ``tol`` of its largest magnitude."""
    want = dict(flatten(want))
    got = dict(flatten(got))
    assert got.keys() == want.keys(), what
    for path, g in got.items():
        w = want[path].float().numpy()
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (what, path, err, np.abs(w).max())


def _reference_run(arch: str, steps: int, tmp_path):
    jcfg = jax_get_reduced(arch)
    jparams = jax_zoo.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = jax_init_opt_state(jparams, JaxAdamWConfig(moment_dtype=jcfg.opt_state_dtype))
    start = {"params": _numpy(jparams), "opt": _numpy(jopt)}     # before the jit donates them
    out = JaxTrainer(jcfg, JaxTrainerConfig(steps=steps, batch=2, seq_len=12,
                                            ckpt_dir=str(tmp_path / "ref"), ckpt_every=100)
                     ).run(start_state={"params": jparams, "opt": jopt})
    return start, out


def test_trainer_matches_reference_from_one_state(tmp_path):
    start, jout = _reference_run("qwen3-1.7b", 6, tmp_path)
    trainer = Trainer(get_reduced("qwen3-1.7b"),
                      TrainerConfig(steps=6, batch=2, seq_len=12, ckpt_dir=str(tmp_path / "port"),
                                    ckpt_every=100), device="cpu")
    out = trainer.run(start_state={"params": lm_params_from_reference(start["params"], "cpu"),
                                   "opt": opt_state_from_reference(start["opt"], "cpu")})
    assert out["final_step"] == jout["final_step"] == 6
    assert [m["step"] for m in out["metrics"]] == list(range(6))
    for got, want in zip(out["metrics"], jout["metrics"]):
        assert got["lr"] == want["lr"]
        for k in ("loss", "gnorm"):
            assert abs(got[k] - want[k]) <= STEP_RTOL * abs(want[k]), (got, want)
    jstate = _numpy(jout["state"])
    _assert_leaves_close(out["state"]["params"], lm_params_from_reference(jstate["params"], "cpu"),
                         PARAM_TOL, "params")
    _assert_leaves_close(out["state"]["opt"], opt_state_from_reference(jstate["opt"], "cpu"),
                         MOMENT_TOL, "opt")
    assert int(out["state"]["opt"]["count"]) == 6
    assert (tmp_path / "port" / "step_00000006" / "manifest.json").exists()


def test_restarted_run_ends_bit_equal_to_an_uninterrupted_one(tmp_path):
    """The port's twin of the reference's tests/test_ckpt.py restart test: a
    crash at step 3 resumes from the step-2 checkpoint."""
    cfg = get_reduced("qwen3-1.7b")
    tcfg = lambda name: TrainerConfig(steps=6, ckpt_every=2, batch=2, seq_len=12,
                                      ckpt_dir=str(tmp_path / name))
    clean = Trainer(cfg, tcfg("clean"), device="cpu").run()
    restarted = Trainer(cfg, tcfg("crash"), injector=FailureInjector(fail_at_steps=(3,)),
                        device="cpu").run_with_restarts()
    assert restarted["restarts"] == 1 and restarted["final_step"] == 6
    assert [m["step"] for m in restarted["metrics"]] == [0, 1, 2, 2, 3, 4, 5]
    a, b = dict(flatten(clean["state"])), dict(flatten(restarted["state"]))
    assert a.keys() == b.keys()
    for path in a:
        assert torch.equal(a[path], b[path]), path
    assert [m["loss"] for m in clean["metrics"]] == \
        [m["loss"] for m in restarted["metrics"][:3] + restarted["metrics"][4:]]


@pytest.mark.parametrize("fail_at", [(1,), (1, 3)])
def test_restart_before_the_first_checkpoint_starts_from_the_seeded_state(tmp_path, fail_at):
    """A crash at step 1, before the first checkpoint (every 2 steps), must
    restart from a fresh seeded state, not from the one the failed attempt
    stepped in place; with a second crash at step 3 the run then resumes
    from the step-2 checkpoint. Both end bit-equal to an uninterrupted run."""
    cfg = get_reduced("qwen3-1.7b")
    tcfg = lambda name: TrainerConfig(steps=6, ckpt_every=2, batch=2, seq_len=12,
                                      ckpt_dir=str(tmp_path / name))
    clean = Trainer(cfg, tcfg("clean"), device="cpu").run()
    restarted = Trainer(cfg, tcfg("crash"), injector=FailureInjector(fail_at_steps=fail_at),
                        device="cpu").run_with_restarts()
    assert restarted["restarts"] == len(fail_at) and restarted["final_step"] == 6
    assert [m["step"] for m in restarted["metrics"]] == \
        ([0, 0, 1, 2, 3, 4, 5] if fail_at == (1,) else [0, 0, 1, 2, 2, 3, 4, 5])
    assert int(restarted["state"]["opt"]["count"]) == 6
    a, b = dict(flatten(clean["state"])), dict(flatten(restarted["state"]))
    assert a.keys() == b.keys()
    for path in a:
        assert torch.equal(a[path], b[path]), path


def test_try_restore_loads_into_the_live_state_in_place(tmp_path):
    trainer = Trainer(get_reduced("qwen3-1.7b"),
                      TrainerConfig(batch=2, seq_len=12, ckpt_dir=str(tmp_path)), device="cpu")
    state = trainer.init_state()
    assert trainer.try_restore(state) is None
    trainer.save(state, 4)
    saved = [t.clone() for t in leaves(state)]
    for t in leaves(state):
        t.add_(1)
    ptrs = [t.data_ptr() for t in leaves(state)]
    assert trainer.try_restore(state) == 4
    assert [t.data_ptr() for t in leaves(state)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(leaves(state), saved))


def test_launch_train_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--reduced",
                           "--device", "cpu", "--steps", "4", "--ckpt-every", "2",
                           "--ckpt-dir", str(tmp_path / "ckpt")], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["final_step"] == 4 and out["restarts"] == 0
    assert np.isfinite(out["last_loss"]) and out["straggler_stats"]["primary"] == 4
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002", "step_00000004"]


def test_launch_train_distger_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--distger",
                           "--device", "cpu", "--graph-nodes", "300"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["nodes"] == 300 and out["edges"] > 0 and out["dim"] == 128
