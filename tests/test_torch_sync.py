"""The hotness-block sync (``repro_torch.core.sync``) and the replica regime
of DSGL against the JAX reference: the sampled rows equal, the exchange
bit-exact, one synced chunk from the same imported S = 2 state within
5e-4, and the streaming pipeline continuing a reference run saved at
k = 2 (its replicas, ring, keys and MPGP assignment) within 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sync as jax_sync
from repro_torch import convert, prng
from repro_torch.core import dsgl, sync
from repro_torch.core.api import EmbedConfig, make_walk_plan
from repro_torch.core.corpus import FrequencyOrder
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

TOL = 5e-4


def _blocks(seed=0, n=400):
    ocn = np.random.default_rng(seed).zipf(1.6, n).clip(max=300)
    return FrequencyOrder.from_ocn(ocn).hotness_blocks()


def test_sample_hotness_rows_equal():
    starts, ends = _blocks()
    for seed in (0, 7):
        got = sync.sample_hotness_rows(starts, ends, np.random.default_rng(seed))
        want = jax_sync.sample_hotness_rows(starts, ends, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    empty = np.zeros(0, np.int64)
    assert sync.sample_hotness_rows(empty, empty, np.random.default_rng(0)).size == 0


@pytest.mark.parametrize("s", [2, 3, 4])
def test_hotness_sync_stacked_exact(s):
    rng = np.random.default_rng(s)
    phi_in = rng.standard_normal((s, 300, 16)).astype(np.float32)
    phi_out = rng.standard_normal((s, 300, 16)).astype(np.float32)
    starts, ends = _blocks(s, 300)
    rows = sync.sample_hotness_rows(starts, ends, rng)
    want_in, want_out = jax_sync.hotness_sync_stacked(
        jnp.asarray(phi_in), jnp.asarray(phi_out), jnp.asarray(rows, jnp.int32))
    got_in, got_out = torch.from_numpy(phi_in.copy()), torch.from_numpy(phi_out.copy())
    sync.hotness_sync_stacked(got_in, got_out, torch.from_numpy(rows))
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    # Repeats of a row (the padding of a graph's static rows buffer) change nothing.
    again_in, again_out = torch.from_numpy(phi_in.copy()), torch.from_numpy(phi_out.copy())
    padded = torch.from_numpy(np.concatenate([rows, np.repeat(rows[-1:], 5)]))
    sync.hotness_sync_stacked(again_in, again_out, padded)
    assert torch.equal(again_in, got_in) and torch.equal(again_out, got_out)


def test_replica_list_syncs_and_cost_model_exact():
    rng = np.random.default_rng(5)
    arrays = [(rng.standard_normal((200, 8)).astype(np.float32),
               rng.standard_normal((200, 8)).astype(np.float32)) for _ in range(3)]
    starts, ends = _blocks(5, 200)
    ref_reps = [(jnp.asarray(a), jnp.asarray(b)) for a, b in arrays]
    reps = [(torch.from_numpy(a.copy()), torch.from_numpy(b.copy())) for a, b in arrays]
    want, want_bytes = jax_sync.hotness_block_sync(ref_reps, starts, ends,
                                                   np.random.default_rng(9))
    got, got_bytes = sync.hotness_block_sync(reps, starts, ends, np.random.default_rng(9))
    assert got_bytes == want_bytes
    for (gi, go), (wi, wo), (ai, _) in zip(got, want, arrays):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    assert np.array_equal(reps[0][0].numpy(), arrays[0][0])      # inputs untouched
    want, want_bytes = jax_sync.full_sync(ref_reps)
    got, got_bytes = sync.full_sync(reps)
    assert got_bytes == want_bytes
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1][0]))
    np.testing.assert_array_equal(got[2][1].numpy(), np.asarray(want[2][1]))
    assert sync.full_sync(reps[:1]) == (reps[:1], 0.0)
    assert sync.sync_cost_model(1000, 64, 4, 37) == jax_sync.sync_cost_model(1000, 64, 4, 37)


@pytest.fixture(scope="module")
def reference_run_k2(small_graph):
    """The reference's streaming pipeline at k = 2 (MPGP assignment, two
    replicas) after one walk round and 60 training steps (one sync at the
    step-50 boundary), as numpy."""
    from repro.core.api import EmbedConfig as JaxEmbedConfig
    from repro.core.api import make_walk_plan as jax_make_walk_plan
    from repro.core.dsgl import DSGLConfig as JaxDSGLConfig
    from repro.core.mpgp import mpgp_partition
    from repro.runtime.trainer import StreamingEmbedPipeline as JaxPipeline

    kw = dict(dim=16, max_len=12, min_len=4, window=3, negatives=4, seed=2)
    policy, spec, rounds = jax_make_walk_plan(JaxEmbedConfig(**kw))
    cfg = JaxDSGLConfig(dim=16, window=3, negatives=4, seed=2, batch_groups=8)
    part = mpgp_partition(small_graph, 2).assignment
    pipe = JaxPipeline(small_graph, policy, spec, rounds, cfg, assignment=part, num_shards=2)
    pipe._append(pipe._run_round(0), 0)
    pipe._train_slots(0, small_graph.num_nodes, np.asarray(pipe.ring.ocn), 60)
    tree = jax.tree_util.tree_map(np.asarray, pipe._state_tree())
    return pipe, tree, cfg, kw


def test_one_synced_chunk_from_reference_state(reference_run_k2):
    """One chunk of S = 2 replicas ending with the hotness sync, from the
    same imported state, both packages: phi within 5e-4."""
    from repro.core import dsgl as jax_dsgl

    pipe, tree, cfg, _ = reference_run_k2
    state = convert.from_reference_state(tree, device="cpu")
    assert state["phi_in"].shape[0] == 2
    ocn = tree["ring"]["ocn"]
    order = FrequencyOrder.from_ocn(ocn)
    rows = order.to_node[sync.sample_hotness_rows(*order.hotness_blocks(),
                                                  np.random.default_rng(4))]
    walks = tree["ring"]["walks"][np.random.default_rng(5).integers(
        0, tree["ring"]["walks"].shape[0], (3, 2, cfg.batch_groups, cfg.multi_windows))]
    lrs = np.asarray([0.025, 0.02, 0.015], np.float32)
    want_in, want_out, want_loss = jax_dsgl.train_chunk(
        jnp.asarray(tree["phi_in"]), jnp.asarray(tree["phi_out"]), jnp.asarray(walks),
        jax_dsgl.build_alias_table(ocn, 0.75), jnp.asarray(rows, jnp.int32),
        jax.random.fold_in(pipe.key_train, 7), jnp.asarray(lrs), cfg.window, cfg.negatives,
        False, True)
    phi_in, phi_out = state["phi_in"].clone(), state["phi_out"].clone()
    losses = dsgl.train_chunk(phi_in, phi_out, torch.from_numpy(walks),
                              dsgl.build_alias_table(ocn, 0.75, "cpu"),
                              prng.fold_in(state["key_train"], 7), lrs, cfg.window,
                              cfg.negatives, sync_rows=torch.from_numpy(rows.astype(np.int64)),
                              sync=True)
    np.testing.assert_allclose(phi_in.numpy(), np.asarray(want_in), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(phi_out.numpy(), np.asarray(want_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_loss), rtol=TOL)
    # The synced rows are equal across the replicas, the others are not.
    r = torch.from_numpy(rows.astype(np.int64))
    assert torch.equal(phi_in[0, r], phi_in[1, r])
    assert not torch.equal(phi_in[0], phi_in[1])


def test_pipeline_continues_reference_state_at_k2(reference_run_k2, small_graph):
    """The port's pipeline adopts the reference's k = 2 state (replicas,
    ring, keys, MPGP assignment) and both train the same steps across a
    sync boundary: phi within 5e-4, the same syncs, the replica mean."""
    pipe, tree, cfg, kw = reference_run_k2
    state = convert.from_reference_state(tree, device="cpu")
    np.testing.assert_array_equal(state["assignment"], tree["assignment"])
    policy, spec, rounds = make_walk_plan(EmbedConfig(**kw))
    port = StreamingEmbedPipeline(state["graph"], policy, spec, rounds,
                                  dsgl.DSGLConfig(dim=16, window=3, negatives=4, seed=2,
                                                  batch_groups=8), num_shards=2)
    port.adopt_state(state)
    np.testing.assert_array_equal(port.assignment, tree["assignment"])
    port.global_step = pipe.global_step
    assert (port.total_steps, port.steps_per_round) == (pipe.total_steps, pipe.steps_per_round)
    ocn = tree["ring"]["ocn"]
    n = small_graph.num_nodes
    steps = 100 - pipe.global_step + 5           # across the step-100 boundary
    pipe._train_slots(0, n, ocn, steps)
    port._train_slots(0, n, ocn, steps)
    assert port.global_step == pipe.global_step and port.syncs == 1
    blocks = len(FrequencyOrder.from_ocn(ocn).hotness_blocks()[0])
    assert port.sync_bytes == blocks * 16 * 4 * 2 * 2      # rows x d x 4 B x S x 2 matrices
    np.testing.assert_allclose(port.phi_in.numpy(), np.asarray(pipe.phi_in), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port.phi_out.numpy(), np.asarray(pipe.phi_out), atol=TOL,
                               rtol=TOL)
    want_in, _ = pipe.embeddings()
    got_in, _ = port.embeddings()
    np.testing.assert_allclose(got_in.numpy(), want_in, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="replicas"):
        StreamingEmbedPipeline(state["graph"], policy, spec, rounds,
                               dsgl.DSGLConfig(dim=16, window=3, negatives=4, seed=2),
                               num_shards=1).adopt_state(state)


@pytest.fixture(scope="module")
def fixed_corpus(small_graph):
    """A DeepWalk corpus of fixed-length walks (the same walks in both
    packages) and its frequency order."""
    from repro.core.api import EmbedConfig as JaxEmbedConfig
    from repro.core.api import sample_corpus as jax_sample_corpus
    from repro.core.corpus import FrequencyOrder as JaxFrequencyOrder

    corpus = jax_sample_corpus(small_graph, JaxEmbedConfig(
        method="deepwalk", info_termination=False, fixed_len=12, fixed_rounds=3, seed=4))
    return corpus, JaxFrequencyOrder.from_ocn(corpus.ocn)


def test_two_phase_trainers_at_k2_match_reference(fixed_corpus):
    """``train_dsgl`` and ``DSGLTrainer`` at S = 2 over the same corpus,
    both packages: the same chunks, keys and hotness rows, so phi within
    5e-4, the same steps and sync bytes, the losses within 5e-4."""
    from repro.core import dsgl as jax_dsgl
    from repro.runtime.trainer import DSGLTrainer as JaxDSGLTrainer
    from repro_torch.runtime.trainer import DSGLTrainer

    corpus, ref_order = fixed_corpus
    order = FrequencyOrder.from_ocn(corpus.ocn)
    np.testing.assert_array_equal(order.to_node, ref_order.to_node)
    kw = dict(dim=16, window=3, negatives=4, seed=3, batch_groups=8, epochs=2, lr=0.02,
              sync_period=10)
    want = jax_dsgl.train_dsgl(corpus, ref_order, jax_dsgl.DSGLConfig(**kw), num_shards=2,
                               collect_metrics=True)
    got = dsgl.train_dsgl(corpus, order, dsgl.DSGLConfig(**kw), num_shards=2,
                          collect_metrics=True, device="cpu")
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    assert (got[2]["steps"], got[2]["sync_bytes"]) == (want[2]["steps"], want[2]["sync_bytes"])
    np.testing.assert_allclose(got[2]["loss"], want[2]["loss"], rtol=TOL)

    walks = order.relabel_walks(corpus.walks)
    ref_tr = JaxDSGLTrainer(walks, ref_order, jax_dsgl.DSGLConfig(**kw), num_shards=2)
    tr = DSGLTrainer(walks, order, dsgl.DSGLConfig(**kw), num_shards=2, device="cpu")
    want_run, run = ref_tr.run(), tr.run()
    assert (run["steps"], run["sync_bytes"]) == (want_run["steps"], want_run["sync_bytes"])
    assert run["sync_bytes"] > 0
    np.testing.assert_allclose(run["loss"], want_run["loss"], rtol=TOL)
    for a, b in zip(tr.embeddings(), ref_tr.embeddings()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
