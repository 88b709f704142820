"""The port's threefry2x32 against ``jax.random``, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

SEEDS = [0, 7, 123456, 2**31 - 1]


def _key(jkey):
    return tuple(np.asarray(jkey).tolist())


@pytest.mark.parametrize("seed", SEEDS)
def test_key_derivation(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.PRNGKey(seed)
    assert _key(jk) == k
    for d in [0, 1, 5, 4096, 123456789, 2**32 - 1]:
        assert _key(jax.random.fold_in(jk, np.uint32(d))) == prng.fold_in(k, d)
    for num in [2, 3, 5]:
        assert [tuple(r) for r in np.asarray(jax.random.split(jk, num)).tolist()] \
            == prng.split(k, num)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4), (1000,)])
def test_uniform_and_randint(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    k = prng.fold_in(prng.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(k, shape, "cpu").numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    # spans below, at and above 2**16 (where JAX's multiplier wraps to 0)
    for lo, hi in [(0, 10), (0, 65536), (0, 1_138_499), (-5, 70_000), (3, 2**31 - 1)]:
        want = np.asarray(jax.random.randint(jk, shape, lo, hi, dtype=jnp.int32))
        got = prng.randint(k, shape, lo, hi, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("n", [1, 2, 10, 1000, 1625, 1626, 5000])
def test_permutation(n):
    # 1626 is the first size that takes two sort rounds
    for seed in (0, 5):
        jk = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.permutation(jk, n))
        got = prng.permutation(prng.PRNGKey(seed), n, "cpu")
        np.testing.assert_array_equal(want, got.numpy())


def test_batched_keys_match_one_by_one():
    keys = prng.split(prng.PRNGKey(3), 4)
    u = prng.uniform(keys, (2, 3), "cpu")
    r = prng.randint(keys, (5,), 0, 77, "cpu")
    assert u.shape == (4, 2, 3) and r.shape == (4, 5)
    for i, k in enumerate(keys):
        assert torch.equal(u[i], prng.uniform(k, (2, 3), "cpu"))
        assert torch.equal(r[i], prng.randint(k, (5,), 0, 77, "cpu"))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jnp.asarray(k, jnp.uint32), (2, 3))),
            u[i].numpy())


@pytest.mark.parametrize("span", [77, 2**17 + 3])
def test_randint_and_uniform_in_one_pass_match_separate_draws(span):
    ikeys = prng.split(prng.PRNGKey(5), 3)
    fkeys = prng.split(prng.PRNGKey(6), 3)
    r, u = prng.randint_and_uniform(ikeys, fkeys, (4, 7), 2, span, "cpu")
    assert torch.equal(r, prng.randint(ikeys, (4, 7), 2, span, "cpu"))
    assert torch.equal(u, prng.uniform(fkeys, (4, 7), "cpu"))
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jnp.asarray(ikeys[1], jnp.uint32), (4, 7), 2, span)),
        r[1].numpy())


def test_large_draw_crosses_chunks(monkeypatch):
    monkeypatch.setattr(prng, "_CHUNK", 100)
    k = prng.PRNGKey(9)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (37, 11)))
    np.testing.assert_array_equal(want, prng.uniform(k, (37, 11), "cpu").numpy())
