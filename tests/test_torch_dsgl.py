"""DSGL training of the PyTorch port against the JAX reference.

Negative sampling, initialisation and batch indices are bit-exact (same
counter-based draws). A training chunk, run from the same state imported
through ``convert.from_reference_state``, agrees at 5e-4: the two
frameworks sum the lifetime's matrix products and the write-back's
duplicates in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsgl as jax_dsgl
from repro.core.api import EmbedConfig as JaxEmbedConfig
from repro.core.api import make_walk_plan as jax_make_walk_plan
from repro.data.pipeline import ring_chunk_indices as jax_ring_chunk_indices
from repro.runtime.trainer import StreamingEmbedPipeline as JaxPipeline
from repro_torch import convert, prng
from repro_torch.core import dsgl
from repro_torch.core.api import EmbedConfig, make_walk_plan
from repro_torch.data.pipeline import ring_chunk_indices
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

TOL = 5e-4


def test_alias_table_and_draws_bit_exact():
    rng = np.random.default_rng(3)
    ocn = rng.integers(0, 50, 500)
    ocn[::7] = 0
    for counts in (ocn, np.zeros(40, np.int64)):
        ref = jax_dsgl.build_alias_table(counts, 0.75)
        got = dsgl.build_alias_table(counts, 0.75, "cpu")
        np.testing.assert_array_equal(np.asarray(ref.prob).view(np.uint32),
                                      got.prob.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(ref.alias), got.alias.numpy())
        want = jax_dsgl.sample_alias(ref, jax.random.PRNGKey(4), (3, 7, 5))
        draws = dsgl.sample_alias(got, prng.PRNGKey(4), (3, 7, 5))
        np.testing.assert_array_equal(np.asarray(want), draws.numpy())


def test_init_embeddings_bit_exact():
    ref_in, ref_out = jax_dsgl.init_embeddings(300, 24, jax.random.PRNGKey(8))
    got_in, got_out = dsgl.init_embeddings(300, 24, prng.PRNGKey(8), "cpu")
    np.testing.assert_array_equal(np.asarray(ref_in), got_in.numpy())
    np.testing.assert_array_equal(np.asarray(ref_out), got_out.numpy())


@pytest.mark.parametrize("base,pool,count", [(0, 256, 2), (512, 700, 1), (0, 100, 3)])
def test_ring_chunk_indices_bit_exact(base, pool, count):
    # (0, 100, 3) needs more slots than the pool holds: the permutation tiles
    want = jax_ring_chunk_indices(jax.random.PRNGKey(6), base, pool, count, 1, 16, 2)
    got = ring_chunk_indices(prng.PRNGKey(6), base, pool, count, 1, 16, 2, "cpu")
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_lifetime_step_matches_reference():
    """One batch of lifetimes on a single (N, d) pair, with -1 holes
    anywhere in the walks and hub rows repeated (duplicate averaging)."""
    rng = np.random.default_rng(5)
    n, d, g, w, t, k = 40, 8, 4, 2, 12, 3
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    phi_in, phi_out = f(n, d), f(n, d)
    walks = rng.integers(-1, n, (g, w, t)).astype(np.int32)
    negs = rng.integers(0, n, (g, t, k)).astype(np.int32)
    want_in, want_out, want_loss = jax_dsgl.lifetime_step(
        jnp.asarray(phi_in), jnp.asarray(phi_out), jnp.asarray(walks),
        jnp.asarray(negs), jnp.float32(0.025), 3)
    got_in, got_out = torch.from_numpy(phi_in.copy()), torch.from_numpy(phi_out.copy())
    loss = dsgl.lifetime_step(got_in, got_out, torch.from_numpy(walks),
                              torch.from_numpy(negs).to(torch.int64), 0.025, 3)
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)


@pytest.fixture(scope="module")
def reference_run(small_graph):
    """A reference pipeline after its first walk round and two training
    steps, and its state as numpy."""
    kw = dict(dim=16, window=3, negatives=4, max_len=20, min_len=6, seed=2)
    policy, spec, rounds = jax_make_walk_plan(JaxEmbedConfig(**kw))
    cfg = jax_dsgl.DSGLConfig(dim=16, window=3, negatives=4, seed=2, batch_groups=16)
    pipe = JaxPipeline(small_graph, policy, spec, rounds, cfg)
    pipe._append(pipe._run_round(0), 0)
    pipe._train_slots(0, small_graph.num_nodes, np.asarray(pipe.ring.ocn), 2)
    tree = jax.tree_util.tree_map(np.asarray, pipe._state_tree())
    return pipe, tree, cfg, kw


def test_train_chunk_from_reference_state(reference_run):
    pipe, tree, cfg, _ = reference_run
    state = convert.from_reference_state(tree, device="cpu")
    ring = state["ring"]
    np.testing.assert_array_equal(tree["ring"]["walks"], ring.walks.numpy())
    np.testing.assert_array_equal(tree["ring"]["ocn"], ring.ocn.numpy())
    assert (ring.cursor, ring.total) == (int(tree["ring"]["cursor"]), int(tree["ring"]["total"]))
    n = ring.ocn.shape[0]
    ocn = tree["ring"]["ocn"]

    idx_ref = jax_ring_chunk_indices(jax.random.fold_in(pipe.key_train, 123), 0, n,
                                     3, 1, cfg.batch_groups, cfg.multi_windows)
    idx = ring_chunk_indices(prng.fold_in(state["key_train"], 123), 0, n, 3, 1,
                             cfg.batch_groups, cfg.multi_windows, "cpu")
    np.testing.assert_array_equal(np.asarray(idx_ref), idx.numpy())
    lrs = np.asarray([0.025, 0.02, 0.015], np.float32)

    want_in, want_out, want_loss = jax_dsgl.train_chunk(
        jnp.asarray(tree["phi_in"]), jnp.asarray(tree["phi_out"]),
        jnp.asarray(tree["ring"]["walks"])[idx_ref],
        jax_dsgl.build_alias_table(ocn, 0.75), jnp.zeros(0, jnp.int32),
        jax.random.fold_in(pipe.key_train, 999), jnp.asarray(lrs),
        cfg.window, cfg.negatives, False, False)
    phi_in, phi_out = state["phi_in"].clone(), state["phi_out"].clone()
    losses = dsgl.train_chunk(
        phi_in, phi_out, ring.walks[idx], dsgl.build_alias_table(ocn, 0.75, "cpu"),
        prng.fold_in(state["key_train"], 999), lrs, cfg.window, cfg.negatives)
    assert not torch.equal(phi_in, state["phi_in"])            # it trained
    np.testing.assert_allclose(phi_in.numpy(), np.asarray(want_in), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(phi_out.numpy(), np.asarray(want_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_loss), rtol=TOL)

    # The checked variant trains the same chunk on copies and reports health.
    new_in, new_out, losses2, health = dsgl.train_chunk_checked(
        state["phi_in"], state["phi_out"], ring.walks[idx],
        dsgl.build_alias_table(ocn, 0.75, "cpu"),
        prng.fold_in(state["key_train"], 999), lrs, cfg.window, cfg.negatives)
    assert torch.equal(new_in, phi_in) and torch.equal(new_out, phi_out)
    assert int(health["nonfinite"]) == 0 and int(health["loss_nonfinite"]) == 0
    want_norm = np.sqrt(((np.asarray(want_in) - tree["phi_in"]) ** 2).sum()
                        + ((np.asarray(want_out) - tree["phi_out"]) ** 2).sum())
    np.testing.assert_allclose(float(health["update_norm"]), want_norm, rtol=1e-3)
    np.testing.assert_allclose(float(health["loss_sum"]), float(losses.sum()), rtol=1e-6)


def test_pipeline_continues_from_reference_state(reference_run, small_graph):
    """Both pipelines train the next round's steps from the same state."""
    pipe, tree, cfg, kw = reference_run
    state = convert.from_reference_state(tree, device="cpu")
    policy, spec, rounds = make_walk_plan(EmbedConfig(**kw))
    port = StreamingEmbedPipeline(state["graph"], policy, spec, rounds,
                                  dsgl.DSGLConfig(dim=16, window=3, negatives=4, seed=2,
                                                  batch_groups=16))
    port.adopt_state(state)
    port.global_step = pipe.global_step
    assert port.total_steps == pipe.total_steps
    n = small_graph.num_nodes
    ocn = tree["ring"]["ocn"]
    pipe._train_slots(0, n, ocn, 3)
    port._train_slots(0, n, ocn, 3)
    assert port.global_step == pipe.global_step
    np.testing.assert_allclose(port.phi_in.numpy(), np.asarray(pipe.phi_in),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port.phi_out.numpy(), np.asarray(pipe.phi_out),
                               atol=TOL, rtol=TOL)
