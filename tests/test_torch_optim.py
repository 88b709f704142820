"""The port's optimizers, schedules, gradient compression and LM data
stream against the JAX reference's, on the same trees and steps.

Tolerances: schedules within 2 float32 ULP of the reference's value (both
compute in float32 in the same order; ``cos`` may differ in its last bit);
an optimizer step within 1e-6 of each leaf's largest magnitude (the same
float32 arithmetic; only the global norm's sum runs in another order), or
within one bfloat16 rounding (2^-7 of it) where a value is stored in
bfloat16;
compression, hotness blocks and token batches bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenStream as JaxTokenStream
from repro.optim import compression as jax_compression
from repro.optim import optimizers as jax_opt
from repro.optim import schedules as jax_schedules
from repro_torch.data.pipeline import BackupShardFetcher, TokenStream
from repro_torch.optim import compression, optimizers, schedules
from repro_torch.optim.optimizers import (AdamWConfig, SGDConfig, clip_by_global_norm,
                                          global_norm, init_opt_state, opt_update)

torch.set_num_threads(1)

F32_EPS = float(np.finfo(np.float32).eps)
STEP_TOL = 1e-6


def _tree(rng, dtype=np.float32):
    """A small parameter-like tree: nested dicts and a list."""
    mk = lambda *shape: (rng.standard_normal(shape) * 0.5).astype(dtype)
    return {"embed": {"table": mk(11, 6)}, "final_norm": {"scale": mk(6)},
            "group_0": [{"b0": {"w": mk(6, 5), "b": mk(5)}} for _ in range(2)]}


def _to_torch(tree, dtype=None):
    return optimizers.tree_map(lambda a: torch.tensor(a, dtype=dtype), tree)


def _to_jax(tree, dtype=None):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _assert_tree_close(got, want, tol, what=""):
    got_l, want_l = optimizers.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), what


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)), ("linear_warmup", (0.1, 100, 5000)),
    ("linear_warmup", (0.1, 10, 50, 0.2)), ("cosine_warmup", (0.1, 100, 5000)),
    ("cosine_warmup", (3e-4, 10, 20)), ("word2vec_linear", (0.025, 1e-4, 5000))])
def test_schedules_match_reference(name, args):
    port, ref = getattr(schedules, name)(*args), getattr(jax_schedules, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 19, 20, 99, 100, 101, 2500, 4999, 5000, 7000):
        got, want = port(step), float(ref(jnp.int32(step)))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 2 * F32_EPS * abs(want), (name, step)
        assert 0.0 <= float(got) <= args[0] + 1e-6


@pytest.mark.parametrize("cfg", [AdamWConfig(), AdamWConfig(weight_decay=0.0, grad_clip=0.0),
                                 AdamWConfig(moment_dtype="bfloat16"), SGDConfig(),
                                 SGDConfig(weight_decay=0.01, grad_clip=0.5)])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_optimizer_steps_match_reference(cfg, pdtype):
    """Three steps on the same trees; the parameters, the moments (in their
    stored dtype) and the gradient norms against the reference's."""
    rng = np.random.default_rng(0)
    p_np = _tree(rng)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[pdtype]
    jcfg = getattr(jax_opt, type(cfg).__name__)(**cfg.__dict__)
    jp, p = _to_jax(p_np, jdt), _to_torch(p_np, tdt)
    jstate, state = jax_opt.init_opt_state(jp, jcfg), init_opt_state(p, cfg)
    for step in range(3):
        g_np = optimizers.tree_map(lambda a: (rng.standard_normal(a.shape) * 2).astype(np.float32),
                                   p_np)
        lr = schedules.cosine_warmup(0.01, 1, 10)(step + 1)
        jp, jstate, jn = jax_opt.opt_update(_to_jax(g_np, jdt), jstate, jp, jcfg,
                                            jnp.float32(float(lr)))
        out_p, state, n = opt_update(_to_torch(g_np, tdt), state, p, cfg, lr)
        assert out_p is p
        assert abs(float(n) - float(jn)) <= 1e-6 * float(jn)
    tol = STEP_TOL if pdtype == "float32" else 2 ** -7   # one bf16 rounding apart
    _assert_tree_close(p, jp, tol, "params")
    for name in ("m", "v") if isinstance(cfg, AdamWConfig) else ("m",):
        assert all(t.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            cfg.moment_dtype] for t in optimizers.leaves(state[name]))
        mtol = STEP_TOL if cfg.moment_dtype == "float32" and pdtype == "float32" else 2 ** -7
        _assert_tree_close(state[name], jstate[name], mtol, name)
    assert int(state["count"]) == int(jstate["count"]) == 3
    assert all(t.dtype == tdt for t in optimizers.leaves(p))


def test_adamw_first_step_is_lr_sized():
    params = {"w": torch.ones(4)}
    cfg = AdamWConfig(weight_decay=0.0, grad_clip=0.0)
    state = init_opt_state(params, cfg)
    before = params["w"].clone()
    opt_update({"w": torch.full((4,), 0.5)}, state, params, cfg, torch.tensor(0.1))
    np.testing.assert_allclose((before - params["w"]).numpy(), 0.1 * np.ones(4), rtol=1e-4)
    assert int(state["count"]) == 1


def test_global_norm_and_clip_match_reference():
    grads = {"a": np.full((3,), 4.0, np.float32), "b": np.zeros((2,), np.float32),
             "c": [np.arange(5, dtype=np.float32)]}
    clipped, norm = clip_by_global_norm(_to_torch(grads), 1.0)
    jclipped, jnorm = jax_opt.clip_by_global_norm(_to_jax(grads), 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-7)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    _assert_tree_close(clipped, jclipped, 1e-7)
    same, _ = clip_by_global_norm(_to_torch(grads), 100.0)        # under the clip: unchanged
    _assert_tree_close(same, _to_jax(grads), 0.0)


def test_hotness_sync_matches_reference():
    counts = np.array([9, 9, 5, 5, 5, 2, 1, 1, 1, 1])
    hs = compression.HotnessSync.from_counts(counts, period=2)
    jhs = jax_compression.HotnessSync.from_counts(counts, period=2)
    np.testing.assert_array_equal(hs.block_starts, jhs.block_starts)
    np.testing.assert_array_equal(hs.block_ends, jhs.block_ends)
    for seed in range(3):
        np.testing.assert_array_equal(hs.sample_rows(np.random.default_rng(seed)),
                                      jhs.sample_rows(np.random.default_rng(seed)))
    assert hs.bytes_per_period(16, 4) == jhs.bytes_per_period(16, 4)
    assert hs.full_bytes(10, 16, 4) == jhs.full_bytes(10, 16, 4)
    assert [hs.due() for _ in range(4)] == [jhs.due() for _ in range(4)] == [False, True] * 2


def test_topk_error_feedback_matches_reference_with_ties():
    """Tied magnitudes (of both signs) straddle the k-th place: the port keeps
    the lowest indices, as ``lax.top_k`` does; two rounds, so the residual
    carries over."""
    rng = np.random.default_rng(3)
    g1 = {"w": np.array([1, -3, 3, 2, -3, 3, 0.5, -2], np.float32),
          "b": [rng.standard_normal((4, 5)).astype(np.float32)]}
    g1["b"][0][1, :] = 1.25
    g2 = {"w": np.array([2, 2, -2, 2, 1, 0, 0, 2], np.float32),
          "b": [np.round(rng.standard_normal((4, 5))).astype(np.float32)]}
    port = compression.TopKErrorFeedback(k_frac=0.25)
    ref = jax_compression.TopKErrorFeedback(k_frac=0.25)
    for g in (g1, g2):
        sparse, resid = port.compress(_to_torch(g))
        jsparse, jresid = ref.compress(_to_jax(g))
        _assert_tree_close(sparse, jsparse, 0.0)
        _assert_tree_close(resid, jresid, 0.0)
    assert port.wire_bytes(_to_torch(g1)) == ref.wire_bytes(_to_jax(g1))


@pytest.mark.parametrize("shard", [0, 1])
def test_token_stream_matches_reference(shard):
    kw = dict(vocab_size=1000, batch_per_shard=3, seq_len=9, seed=4, shard_id=shard,
              num_shards=2)
    port, ref = TokenStream(**kw), JaxTokenStream(**kw)
    for step in (0, 1, 7, 123):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(next(iter(port))["tokens"], ref.batch_at(0)["tokens"])


def test_backup_fetcher_takes_the_backup_when_the_primary_is_slow():
    s = TokenStream(vocab_size=100, batch_per_shard=1, seq_len=4, seed=0)
    f = BackupShardFetcher(primary=s.batch_at, backup=s.batch_at, deadline_s=0.05,
                           delay_injector=lambda step: 2.0 if step == 2 else 0.0)
    outs = [f.fetch(i) for i in range(4)]
    assert f.stats == {"primary": 3, "backup": 1}
    for i, out in enumerate(outs):       # speculation returns the primary's bytes
        np.testing.assert_array_equal(out["tokens"], s.batch_at(i)["tokens"])
