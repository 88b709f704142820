"""The SGNS lifetime update: the port's plain version against the JAX
reference and the JAX Pallas kernel (interpret mode), at 5e-4 — the
tolerance of the reference's own kernel tests. The CUDA kernel runs only
on the card (``-m cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sgns import ops as jax_ops
from repro.kernels.sgns import ref as jax_ref
from repro_torch.kernels.sgns import ops, ref

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

TOL = 5e-4
SHAPES = [(2, 16, 32, 5, 3), (1, 24, 16, 4, 5), (3, 12, 64, 2, 2)]   # w, t, d, k, window


def _inputs(g, w, t, d, k, seed, all_valid=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    valid = np.ones((g, w, t), bool) if all_valid else rng.random((g, w, t)) > 0.2
    return f(g, w, t, d), f(g, w, t, d), f(g, t, k, d), valid


def _close(got, want, what):
    for a, b, name in zip(got, want, ("ctx", "out", "neg", "loss")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("w,t,d,k,window", SHAPES)
def test_lifetime_ref_matches_jax_ref_and_pallas(w, t, d, k, window):
    ctx, out, neg, valid = _inputs(1, w, t, d, k, seed=w * t)
    lr = 0.01
    want = jax_ref.sgns_lifetime_ref(*(jnp.asarray(a[0]) for a in (ctx, out, neg, valid)),
                                     jnp.float32(lr), window)
    got = ref.sgns_lifetime_ref(*(torch.from_numpy(a[0]) for a in (ctx, out, neg, valid)),
                                lr, window)
    _close([g.numpy() for g in got], want, "vs jax ref")
    pallas = jax_ops.sgns_lifetime_batch(*(jnp.asarray(a) for a in (ctx, out, neg, valid)),
                                         jnp.float32(lr), window)
    _close([g.numpy() for g in got], [p[0] for p in pallas], "vs pallas")


def test_batch_wrapper_on_cpu_runs_plain_version():
    ctx, out, neg, valid = _inputs(2, 2, 12, 16, 3, seed=9, all_valid=True)
    lr = 0.025
    before = ops.LAUNCHES
    got = ops.sgns_lifetime_batch(*(torch.from_numpy(a) for a in (ctx, out, neg, valid)),
                                  lr, 4)
    assert ops.LAUNCHES == before          # the CPU never reaches the kernel
    want = jax_ref.sgns_lifetime_batch_ref(*(jnp.asarray(a) for a in (ctx, out, neg, valid)),
                                           jnp.float32(lr), 4)
    _close([g.numpy() for g in got], want, "batch vs jax ref")
    pallas = jax_ops.sgns_lifetime_batch(*(jnp.asarray(a) for a in (ctx, out, neg, valid)),
                                         jnp.float32(lr), 4)
    _close([g.numpy() for g in got], pallas, "batch vs pallas")


def test_invalid_rows_leave_buffers_untouched():
    """A lifetime with no valid token trains nothing: its rows come back
    unchanged and it adds no loss, as in the JAX reference and kernel."""
    ctx, out, neg, valid = _inputs(2, 2, 10, 8, 3, seed=4)
    valid[1] = False
    got = ref.sgns_lifetime_batch_ref(*(torch.from_numpy(a) for a in (ctx, out, neg, valid)),
                                      0.05, 3)
    jax_args = [jnp.asarray(a) for a in (ctx, out, neg, valid)] + [jnp.float32(0.05), 3]
    _close([g.numpy() for g in got], jax_ref.sgns_lifetime_batch_ref(*jax_args),
           "dead lifetime vs jax ref")
    _close([g.numpy() for g in got], jax_ops.sgns_lifetime_batch(*jax_args),
           "dead lifetime vs pallas")
    np.testing.assert_array_equal(got[0][1].numpy(), ctx[1])
    np.testing.assert_array_equal(got[1][1].numpy(), out[1])
    np.testing.assert_array_equal(got[2][1].numpy(), neg[1])
    assert got[3][1].item() == 0.0


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g,w,t,d,k,window", [(64, 2, 100, 128, 5, 10),
                                              (5, 2, 37, 96, 5, 10),
                                              (7, 3, 23, 128, 4, 5),
                                              (6, 2, 30, 128, 14, 4)])
def test_cuda_kernel_matches_plain_version(cuda_device, g, w, t, d, k, window):
    ctx, out, neg, valid = (torch.from_numpy(a).to(cuda_device)
                            for a in _inputs(g, w, t, d, k, seed=g))
    before = ops.LAUNCHES
    got = ops.sgns_lifetime_batch(ctx, out, neg, valid, 0.025, window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = ref.sgns_lifetime_batch_ref(ctx, out, neg, valid, 0.025, window)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
    assert torch.all((got[3] - want[3]).abs() <= TOL * want[3].abs().clamp_min(1.0))
