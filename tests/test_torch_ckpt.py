"""Snapshots of the port in the JAX package's on-disk layout.

``repro_torch.ckpt`` against ``repro.ckpt``: the same leaf numbering (JAX's
flatten order), paths, dtypes and shapes, bfloat16 as raw bits, each
package reading the other's files; an atomic commit, and the reader's
fallbacks (a torn manifest, a missing leaf, a stale ``.tmp``), retention.
Then the pipelines: a snapshot the reference's ``StreamingEmbedPipeline``
wrote is resumed by the port's, and the reverse, and the restored states
are equal bit for bit (phi, the ring, the slot maps, the keys, the
controller, the cursors); the port re-saving the reference's state writes
the reference's manifest; the ΔD gate's state round-trips into either
package's gate; and the port, resuming the reference's mid-run snapshot
(taken in the reference's default ``overlap=True`` order), continues to the
reference's ring and occurrence counts bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import (flatten, latest_step, load_checkpoint, prune_steps,
                                         read_meta, restore_into, save_checkpoint, valid_steps)
from repro_torch.core.api import EmbedConfig, make_walk_plan
from repro_torch.core.dsgl import DSGLConfig
from repro_torch.core.termination import WalkCountController
from repro_torch.graph.csr import CSRGraph
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

#: A fixed-mode DeepWalk plan (walks bit-exact in both packages), short walks.
PLAN = dict(method="deepwalk", info_termination=False, fixed_len=20, fixed_rounds=4, dim=16,
            seed=3, rng_mode="vertex")
DSGL = dict(dim=16, seed=3, batch_groups=16)


def _tree(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g),
                   "b": torch.randn(4, generator=g).to(torch.bfloat16)},
        "opt": {"m": torch.randn(8, 4, generator=g), "count": torch.tensor(7, dtype=torch.int32),
                "steps": [np.arange(3, dtype=np.int64), np.float32(0.5)]},
        "skipped": None,
    }


def _leaves(tree):
    return [leaf for _, leaf in flatten(tree)]


def _same(a, b) -> bool:
    a, b = (torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
            for x in (a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


# --- the layout -------------------------------------------------------------


def test_flatten_order_is_jax_tree_order():
    import jax

    from repro.ckpt.checkpoint import _path_str

    tree = {"ring": {"walks": 1, "cursor": 2}, "b": [3, {"z": 4, "a": 5}], "a": 6, "n": None}
    want = [(_path_str(p), v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert flatten(tree) == want


def test_save_restore_bit_exact(tmp_path):
    tree = _tree(0)
    save_checkpoint(str(tmp_path), 3, tree, meta={"data_step": 3})
    step, arrays, meta = load_checkpoint(str(tmp_path))
    assert step == 3 and meta["data_step"] == 3
    manifest = json.load(open(tmp_path / "step_00000003" / "manifest.json"))
    assert manifest["leaves"]["params/b"] == {"file": "leaf_00004.npy", "dtype": "bfloat16",
                                              "shape": [4]}
    template = {"params": {k: torch.zeros_like(v) for k, v in tree["params"].items()},
                "opt": {"m": torch.zeros(8, 4), "count": torch.tensor(0, dtype=torch.int32),
                        "steps": [torch.zeros(3, dtype=torch.int64), torch.tensor(0.0)]}}
    restored = restore_into(template, arrays)
    for a, b in zip(_leaves(restored), _leaves(tree)):
        assert _same(a, torch.as_tensor(np.asarray(b)) if not isinstance(b, torch.Tensor) else b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    """Leaves, bfloat16 bits and manifest cross the packages both ways."""
    import jax.numpy as jnp

    from repro.ckpt import checkpoint as ref_ckpt

    tree = _tree(1)
    if writer == "port":
        save_checkpoint(str(tmp_path), 1, tree, meta={"mark": 1})
        step, arrays, meta = ref_ckpt.load_checkpoint(str(tmp_path))
        b = ref_ckpt.restore_into({"b": jnp.zeros(4, jnp.bfloat16)},
                                  {"b": arrays["params/b"]})["b"]
        want_bits = tree["params"]["b"].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(np.asarray(b).view(np.uint16), want_bits)
    else:
        ref_tree = {"params": {"w": jnp.asarray(tree["params"]["w"].numpy()),
                               "b": jnp.asarray(tree["params"]["b"].float().numpy(),
                                                jnp.bfloat16)},
                    "opt": {"m": jnp.asarray(tree["opt"]["m"].numpy()),
                            "count": jnp.int32(7), "steps": list(tree["opt"]["steps"])}}
        ref_ckpt.save_checkpoint(str(tmp_path), 1, ref_tree, meta={"mark": 1})
        step, arrays, meta = load_checkpoint(str(tmp_path))
        b = restore_into({"b": torch.zeros(4, dtype=torch.bfloat16)},
                         {"b": arrays["params/b"]})["b"]
        assert torch.equal(b, tree["params"]["b"])
    assert step == 1 and meta == {"mark": 1}
    np.testing.assert_array_equal(arrays["params/w"], tree["params"]["w"].numpy())
    assert arrays["opt/count"].dtype == np.int32 and int(arrays["opt/count"]) == 7
    np.testing.assert_array_equal(arrays["opt/steps/0"], np.arange(3))


def test_restore_rejects_shape_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(2))
    _, arrays, _ = load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_into({"params": {"w": torch.zeros(9, 4)}}, arrays)


def test_atomic_commit_and_stale_tmp_swept(tmp_path):
    stale = tmp_path / "step_00000009.tmp"
    stale.mkdir()
    (stale / "leaf_00000.npy").write_bytes(b"partial garbage")
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 1, _tree(3))
    save_checkpoint(str(tmp_path), 2, _tree(3))
    assert not any(e.endswith(".tmp") for e in os.listdir(tmp_path))
    assert latest_step(str(tmp_path)) == 2 and valid_steps(str(tmp_path)) == [2, 1]


@pytest.mark.parametrize("damage", ["torn_manifest", "missing_leaf", "missing_manifest"])
def test_damaged_newest_step_is_invisible(tmp_path, damage):
    """A torn or partial newest step costs one snapshot: the reader falls
    back to the newest valid one; an explicit request for it raises."""
    save_checkpoint(str(tmp_path), 1, _tree(4), meta={"mark": "good"})
    save_checkpoint(str(tmp_path), 2, _tree(4), meta={"mark": "damaged"})
    d = tmp_path / "step_00000002"
    if damage == "torn_manifest":
        (d / "manifest.json").write_text('{"step": ')
    elif damage == "missing_leaf":
        os.remove(d / "leaf_00000.npy")
    else:
        os.remove(d / "manifest.json")
    assert latest_step(str(tmp_path)) == 1
    step, _, meta = load_checkpoint(str(tmp_path))
    assert step == 1 and meta["mark"] == "good"
    assert read_meta(str(tmp_path)) == (1, {"mark": "good"})
    with pytest.raises((OSError, ValueError)):
        load_checkpoint(str(tmp_path), step=2)


def test_empty_root(tmp_path):
    assert latest_step(str(tmp_path / "void")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "void"))
    with pytest.raises(FileNotFoundError):
        read_meta(str(tmp_path / "void"))


def test_prune_steps_keeps_the_newest_valid(tmp_path):
    from repro.ckpt.checkpoint import prune_steps as ref_prune

    for root, prune in ((tmp_path / "port", prune_steps), (tmp_path / "ref", ref_prune)):
        for s in range(1, 6):
            save_checkpoint(str(root), s, {"x": np.int64(s)})
        (root / "step_00000005" / "manifest.json").write_text("{")     # torn newest
        (root / "step_00000002" / "manifest.json").write_text("{")     # torn, older
        assert prune(str(root), 2) == 2           # steps 2 (torn) and 1 go
        assert sorted(os.listdir(root)) == ["step_00000003", "step_00000004", "step_00000005"]
        assert latest_step(str(root)) == 4


# --- pipeline snapshots across the packages -----------------------------------


def _port_graph(ref_graph) -> CSRGraph:
    g = ref_graph.to_numpy()
    t = lambda a, dt: None if a is None else torch.from_numpy(np.array(a, dt))
    return CSRGraph(t(g.indptr, np.int64), t(g.indices, np.int64), t(g.weights, np.float32),
                    t(g.edge_cm, np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' pipelines run at k = 2 (MPGP assignment, two replicas)
    on one graph and plan, a snapshot after every round."""
    from repro.core.api import EmbedConfig as RefEmbedConfig
    from repro.core.api import make_walk_plan as ref_plan
    from repro.core.dsgl import DSGLConfig as RefDSGLConfig
    from repro.core.mpgp import mpgp_partition
    from repro.graph.generators import rmat_graph
    from repro.runtime.trainer import StreamingEmbedPipeline as RefPipeline

    graph = rmat_graph(128, 7, seed=7)
    part = np.asarray(mpgp_partition(graph, 2).assignment)
    root = tmp_path_factory.mktemp("ckpt")
    ref_plan_args = (*ref_plan(RefEmbedConfig(**PLAN)), RefDSGLConfig(**DSGL))
    ref = RefPipeline(graph, *ref_plan_args, assignment=part, num_shards=2)
    ref.run(ckpt_root=str(root / "reference"), ckpt_every_rounds=1)
    plan = (*make_walk_plan(EmbedConfig(**PLAN)), DSGLConfig(**DSGL))
    port = StreamingEmbedPipeline(_port_graph(graph), *plan, assignment=part, num_shards=2)
    port.run(ckpt_root=str(root / "port"), ckpt_every_rounds=1)
    return {"root": root, "RefPipeline": RefPipeline, "ref_plan": ref_plan_args,
            "plan": plan}


def assert_same_state(ref, port):
    """The reference pipeline's state and the port's, bit for bit."""
    np.testing.assert_array_equal(np.asarray(ref.phi_in), port.phi_in.numpy())
    np.testing.assert_array_equal(np.asarray(ref.phi_out), port.phi_out.numpy())
    for name in ("walks", "lengths", "ocn"):
        np.testing.assert_array_equal(np.asarray(getattr(ref.ring, name)),
                                      getattr(port.ring, name).numpy(), err_msg=name)
    assert (int(ref.ring.cursor), int(ref.ring.total), ref._cursor) == \
        (port.ring.cursor, port.ring.total, port.ring.cursor)
    np.testing.assert_array_equal(ref._slot_root, port._slot_root)
    np.testing.assert_array_equal(ref._slot_round, port._slot_round)
    for name in ("key_walk", "key_train"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name), np.uint32),
                                      np.asarray(getattr(port, name), np.uint32))
    np.testing.assert_array_equal(np.asarray(ref.assignment), port.assignment)
    assert ref.controller.to_state() == port.controller.to_state()
    cursors = ("global_step", "total_steps", "_rounds_walked", "_trained_rounds", "_phase",
               "walk_shards", "num_shards", "_lr_scale", "_ckpt_seq", "walker_batch")
    assert [getattr(ref, c) for c in cursors] == [getattr(port, c) for c in cursors]
    stats = port.stats()
    assert {k: float(v) for k, v in ref._stats.items()} == \
        {k: float(stats[k]) for k in ref._stats}


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("step", [1, 4])
def test_resume_across_packages_restores_equal_state(runs, writer, step):
    """Each package's ``resume`` of one snapshot: the same state, bit for bit
    (step 1: phase rounds, mid-run; step 4: the final snapshot)."""
    root = str(runs["root"] / writer)
    ref = runs["RefPipeline"].resume(root, *runs["ref_plan"][:2], runs["ref_plan"][3],
                                     step=step)
    port = StreamingEmbedPipeline.resume(root, *runs["plan"][:2], runs["plan"][3], step=step,
                                         device="cpu")
    assert_same_state(ref, port)


def test_port_writes_the_reference_layout(runs, tmp_path):
    """The port resumes the reference's snapshot and saves it again: the
    manifest's leaves (numbering, paths, dtypes, shapes) and every array
    are the reference's; the meta carries every key of the reference's."""
    src = runs["root"] / "reference"
    port = StreamingEmbedPipeline.resume(str(src), *runs["plan"][:2], runs["plan"][3], step=1,
                                         device="cpu")
    port._ckpt_seq = 1
    port.save(str(tmp_path))
    want = json.load(open(src / "step_00000001" / "manifest.json"))
    got = json.load(open(tmp_path / "step_00000001" / "manifest.json"))
    assert got["leaves"] == want["leaves"]
    for path, info in want["leaves"].items():
        np.testing.assert_array_equal(np.load(tmp_path / "step_00000001" / info["file"]),
                                      np.load(src / "step_00000001" / info["file"]),
                                      err_msg=path)
    assert set(want["meta"]) <= set(got["meta"])
    differ = {k for k in want["meta"] if got["meta"][k] != want["meta"][k]}
    assert differ == {"overlap"}, differ       # the port walks after training (meta says so)
    assert got["meta"]["overlap"] is False and want["meta"]["overlap"] is True


def test_resume_refuses_a_foreign_or_missing_snapshot(tmp_path):
    policy, spec, _, dsgl = (*make_walk_plan(EmbedConfig(**PLAN)), DSGLConfig(**DSGL))
    with pytest.raises(FileNotFoundError):
        StreamingEmbedPipeline.resume(str(tmp_path / "nothing"), policy, spec, dsgl,
                                      device="cpu")
    save_checkpoint(str(tmp_path), 0, {"x": np.int64(1)}, meta={"kind": "lm"})
    with pytest.raises(ValueError, match="not a streaming-pipeline snapshot"):
        StreamingEmbedPipeline.resume(str(tmp_path), policy, spec, dsgl, device="cpu")


def test_controller_state_round_trip():
    """``to_state`` / ``from_state`` against the reference's gate."""
    from repro.core.termination import WalkCountController as RefController

    c = WalkCountController(delta=1e-3, min_rounds=2, max_rounds=20, window=3)
    ref = RefController(delta=1e-3, min_rounds=2, max_rounds=20, window=3)
    rng = np.random.default_rng(0)
    d = 1.0
    for _ in range(6):
        d *= 0.7 + 0.02 * rng.standard_normal()
        assert c.update_d(d) == ref.update_d(d)
    assert c.to_state() == ref.to_state()
    c2 = WalkCountController.from_state(ref.to_state())
    assert (c2.history, c2._smooth) == (c.history, c._smooth)
    for nxt in (d * 0.9, d * 0.9001, d * 0.89999):
        assert WalkCountController.from_state(c.to_state()).update_d(nxt) == \
            RefController.from_state(c.to_state()).update_d(nxt)


def test_resume_of_a_reference_snapshot_continues_to_the_reference_ring(tmp_path):
    """The reference walks round r+1 before training round r (``overlap``,
    its default); its mid-run snapshot, resumed by the port, continues to the
    reference's final ring and counts bit for bit, and phi within the
    packages' training tolerance."""
    from repro.core.api import EmbedConfig as RefEmbedConfig
    from repro.core.api import make_walk_plan as ref_plan
    from repro.core.dsgl import DSGLConfig as RefDSGLConfig
    from repro.graph.generators import rmat_graph as ref_rmat
    from repro.runtime.trainer import StreamingEmbedPipeline as RefPipeline

    root = str(tmp_path / "ref")
    ref = RefPipeline(ref_rmat(128, 7, seed=7), *ref_plan(RefEmbedConfig(**PLAN)),
                      RefDSGLConfig(**DSGL))
    assert ref.overlap
    ref.run(ckpt_root=root, ckpt_every_rounds=1)
    policy, spec, _, dsgl = (*make_walk_plan(EmbedConfig(**PLAN)), DSGLConfig(**DSGL))
    port = StreamingEmbedPipeline.resume(root, policy, spec, dsgl, step=1, device="cpu")
    assert (port._phase, port._trained_rounds, port._rounds_walked) == ("rounds", 2, 3)
    res = port.run()
    for name in ("walks", "lengths", "ocn"):
        np.testing.assert_array_equal(np.asarray(getattr(ref.ring, name)),
                                      getattr(port.ring, name).numpy(), err_msg=name)
    assert (port.ring.cursor, port.ring.total) == (int(ref.ring.cursor), int(ref.ring.total))
    np.testing.assert_array_equal(ref._slot_root, port._slot_root)
    np.testing.assert_array_equal(ref._slot_round, port._slot_round)
    assert res["steps"] == ref.global_step and res["rounds"] == ref.controller.rounds
    # Training sums in a different order in each package (test_torch_dsgl: 5e-4 a chunk).
    np.testing.assert_allclose(port.phi_in.numpy(), np.asarray(ref.phi_in), atol=5e-4)
    np.testing.assert_allclose(port.phi_out.numpy(), np.asarray(ref.phi_out), atol=5e-4)
