"""The PyTorch port end to end, against the JAX reference; and the rules
the port keeps: it imports neither JAX nor the reference package, and a
run asked for the card never falls back to the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.common import link_prediction_auc as reference_auc
from repro.core.api import EmbedConfig as JaxEmbedConfig
from repro.core.api import embed_graph as jax_embed_graph
from repro_torch.core.api import EmbedConfig, embed_graph
from repro_torch.eval import link_prediction_auc
from repro_torch.graph.generators import rmat_graph

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("lr,auc_floor", [(0.05, None), (0.01, 0.8)])
def test_embed_graph_auc_matches_reference(medium_graph, lr, auc_floor):
    """The tests/test_e2e.py recipe at num_shards=1, both packages, one
    scorer: the port within 0.02 of the reference. At the recipe's lr 0.05
    a single replica overshoots and the reference itself stays far below
    0.8 (its 0.87 there needs two replicas), so the > 0.8 bar is held at
    lr 0.01. Run with -s to see both AUCs."""
    kw = dict(dim=32, epochs=1, lr=lr, delta=1e-4, max_len=40, min_len=10,
              window=6, negatives=4)
    ref_in, _ = jax_embed_graph(medium_graph, JaxEmbedConfig(**kw), num_shards=1)
    graph = rmat_graph(1024, 10, seed=3, device="cpu")
    phi_in, phi_out, stats = embed_graph(graph, EmbedConfig(**kw), num_shards=1,
                                         return_stats=True, device="cpu")
    assert phi_in.shape == (1024, 32) and torch.isfinite(phi_in).all()
    assert torch.isfinite(phi_out).all()
    assert stats["steps"] == 20 * (1024 // 128)
    auc_ref = link_prediction_auc(graph, np.asarray(ref_in), np.random.default_rng(0))
    auc = link_prediction_auc(graph, phi_in, np.random.default_rng(0))
    # The port's scorer draws the reference scorer's pairs: same AUC.
    assert auc_ref == reference_auc(medium_graph, np.asarray(ref_in),
                                    np.random.default_rng(0))
    print(f"lr {lr}: AUC port {auc:.6f}, reference {auc_ref:.6f}")
    assert abs(auc - auc_ref) <= 0.02, (auc, auc_ref)
    if auc_floor is not None:
        assert auc > auc_floor, auc


RECIPE = dict(dim=32, epochs=1, lr=0.05, delta=1e-4, max_len=40, min_len=10, window=6,
              negatives=4)


def test_embed_graph_recipe_at_two_shards(medium_graph):
    """tests/test_e2e.py's recipe as written (k = 2, lr 0.05), both packages,
    one scorer: the port's replica mean above 0.8 and within 0.02 of the
    reference's; the MPGP partition and the syncs are the reference's."""
    from repro.core.mpgp import mpgp_partition as jax_mpgp_partition

    ref_in, _ = jax_embed_graph(medium_graph, JaxEmbedConfig(**RECIPE), num_shards=2)
    graph = rmat_graph(1024, 10, seed=3, device="cpu")
    phi_in, phi_out, stats = embed_graph(graph, EmbedConfig(**RECIPE), num_shards=2,
                                         return_stats=True, device="cpu")
    assert phi_in.shape == (1024, 32) and torch.isfinite(phi_in).all()
    assert torch.isfinite(phi_out).all()
    part = jax_mpgp_partition(medium_graph, 2)
    assert stats["part_counts"] == part.counts().tolist()
    assert (stats["locality"], stats["balance"]) == (part.locality, part.balance)
    steps = 20 * (1024 // 2 // 128)
    assert stats["steps"] == steps and stats["syncs"] == steps // 50
    auc_ref = link_prediction_auc(graph, np.asarray(ref_in), np.random.default_rng(0))
    auc = link_prediction_auc(graph, phi_in, np.random.default_rng(0))
    print(f"k=2 lr 0.05: AUC port {auc:.6f}, reference {auc_ref:.6f}")
    assert auc > 0.8, auc
    assert abs(auc - auc_ref) <= 0.02, (auc, auc_ref)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_two_phase_path_matches_reference(medium_graph, num_shards):
    """``streaming=False``: the whole corpus, then ``train_dsgl`` in rank
    space, both packages: AUC within 0.02."""
    kw = dict(RECIPE, delta=1e-3)                # fewer walk rounds than the recipe's
    ref_in, _ = jax_embed_graph(medium_graph, JaxEmbedConfig(**kw), num_shards=num_shards,
                                streaming=False)
    graph = rmat_graph(1024, 10, seed=3, device="cpu")
    phi_in, phi_out, corpus = embed_graph(graph, EmbedConfig(**kw), num_shards=num_shards,
                                          streaming=False, return_corpus=True, device="cpu")
    assert phi_in.shape == (1024, 32) and torch.isfinite(phi_in).all()
    assert torch.isfinite(phi_out).all() and corpus.num_walks == corpus.rounds * 1024
    auc_ref = link_prediction_auc(graph, np.asarray(ref_in), np.random.default_rng(0))
    auc = link_prediction_auc(graph, phi_in, np.random.default_rng(0))
    print(f"two-phase k={num_shards}: AUC port {auc:.6f}, reference {auc_ref:.6f}")
    assert abs(auc - auc_ref) <= 0.02, (auc, auc_ref)
    with pytest.raises(ValueError, match="streaming"):
        embed_graph(graph, EmbedConfig(**RECIPE), streaming=False, return_stats=True,
                    device="cpu")


@pytest.mark.parametrize("partitioner", ["mpgp_partition", "hash_partition"])
@pytest.mark.parametrize("method,p,q", [("deepwalk", 1.0, 1.0), ("node2vec", 2.0, 0.5)])
def test_fixed_mode_walks_at_two_shards_equal_sharded_engine(small_graph, method, p, q,
                                                            partitioner):
    """The port's dense engine draws what the reference's partition-sharded
    engine draws under a 2-way assignment, bit for bit: MPGP's (which keeps
    this graph's one component on one shard, so no walk crosses) and the
    hash partition's (whose walks cross shards at most steps)."""
    import jax
    import jax.numpy as jnp

    from repro.core.transition import make_policy as jax_make_policy
    from repro.core.walker import WalkSpec as JaxWalkSpec
    from repro.core.walker import run_walk_batch as jax_run_walk_batch
    from repro_torch import prng
    from repro_torch.core import mpgp
    from repro_torch.core.transition import make_policy
    from repro_torch.core.walker import LaneKeys, WalkSpec, run_walk_batch

    graph = rmat_graph(256, 8, seed=7, device="cpu")
    part = getattr(mpgp, partitioner)(graph, 2).assignment
    kw = dict(max_len=24, info_mode="fixed", fixed_len=24, max_supersteps=0)
    sources = np.arange(graph.num_nodes, dtype=np.int32)
    ref = jax_run_walk_batch(small_graph, jnp.asarray(sources), jax.random.PRNGKey(5),
                             jax_make_policy(method, p=p, q=q), JaxWalkSpec(**kw),
                             jnp.asarray(part), num_shards=2)
    got = run_walk_batch(graph, torch.as_tensor(sources, dtype=torch.int64),
                         LaneKeys.of([prng.PRNGKey(5)], len(sources), len(sources), "cpu"),
                         make_policy(method, p=p, q=q), WalkSpec(**kw))
    assert (int(ref.msg_count) > 0) == (partitioner == "hash_partition")
    np.testing.assert_array_equal(np.asarray(ref.path), got.path.numpy())
    np.testing.assert_array_equal(np.asarray(ref.info.L), got.info.L.numpy())
    assert (int(ref.accepts), int(ref.rejects)) == (int(got.accepts), int(got.rejects))


def test_torch_quickstart_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
                           "--device", "cpu", "--nodes", "300"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "hotness syncs" in proc.stdout and "nearest neighbors of node 0" in proc.stdout


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the request succeeds")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rmat_graph(64, 4, seed=0)                      # device defaults to "cuda"
    graph = rmat_graph(64, 4, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embed_graph(graph, EmbedConfig(dim=8, max_len=12, min_len=4))


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_reference():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)[\s.])")
    offending = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
                 for p in _port_sources()
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if bad.match(line)]
    assert not offending, offending


def test_importing_the_port_loads_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["obs", "ckpt", "common", "runtime.faults", "runtime.health",
                                  "runtime.ingest", "runtime.serve", "kernels.chain_dot",
                                  "graph.io", "core.huge_d"])
def test_durability_and_telemetry_modules_import_neither_jax_nor_reference(name):
    """The telemetry, checkpoint, logging, fault, watchdog, ingest and
    serving modules, the scoring kernel's package, edge-list IO and the
    HuGE-D configurations are copies, not imports, of the JAX package's: no
    ``jax`` or ``repro`` import in their source, and none loaded by
    importing them alone."""
    base = ROOT / "src" / "repro_torch" / Path(*name.split("."))
    files = sorted(base.rglob("*.py")) if base.is_dir() else [base.with_suffix(".py")]
    assert files and all(f in _port_sources() for f in files)
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)[\s.])")
    assert not [f"{f.name}:{i}" for f in files
                for i, line in enumerate(f.read_text().splitlines(), 1) if bad.match(line)]
    mods = [f"repro_torch.{name}"] + [
        "repro_torch." + ".".join(f.relative_to(ROOT / "src" / "repro_torch").with_suffix("")
                                  .parts) for f in files if f.name != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
