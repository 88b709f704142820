"""The chunked SSD scan (Mamba2): the port's plain versions and wrapper
against the JAX reference's ``ssd_scan_reference``, ``ssd_chunked_ref``,
``ssd_decode_step``, its Pallas kernel (interpret mode) and its wrapper,
on the shapes and tolerances of the reference's own kernel tests: 2e-3
for the chunked form against the sequential scan, 3e-3 for the kernel.
The CUDA kernel runs only on the card (``-m cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import kernel as jax_kernel
from repro.kernels.ssm_scan import ops as jax_ops
from repro.kernels.ssm_scan import ref as jax_ref
from repro_torch.kernels.ssm_scan import ops, ref

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)

CHUNKED_TOL, KERNEL_TOL = 2e-3, 3e-3
SHAPES = [(2, 64, 16, 8), (4, 128, 32, 16), (1, 200, 64, 32), (3, 96, 8, 64)]


def _inputs(bh, s, p, n, seed, decay=0.2):
    """numpy draws as the reference's tests make them: xdt, b, c ~ N(0, 1),
    loga ~ -U(0, decay)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bh, s, p)).astype(np.float32),
            (-rng.uniform(size=(bh, s)) * decay).astype(np.float32),
            rng.standard_normal((bh, s, n)).astype(np.float32),
            rng.standard_normal((bh, s, n)).astype(np.float32)]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bh,s,p,n", SHAPES)
def test_plain_versions_match_reference(bh, s, p, n):
    jargs, args = _inputs(bh, s, p, n, seed=bh + s)
    y_seq, s_seq = jax_ref.ssd_scan_reference(*jargs)
    got_y, got_s = ref.ssd_scan_reference(*args)
    _close(got_y, y_seq, CHUNKED_TOL)
    _close(got_s, s_seq, CHUNKED_TOL)
    y_chk, s_chk = jax_ref.ssd_chunked_ref(*jargs, chunk=32)
    got_y, got_s = ref.ssd_chunked_ref(*args, chunk=32)
    _close(got_y, y_chk, CHUNKED_TOL)
    _close(got_s, s_chk, CHUNKED_TOL)
    _close(got_y, y_seq, CHUNKED_TOL)       # chunked against sequential, as the reference
    _close(got_s, s_seq, CHUNKED_TOL)


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_wrapper_matches_pallas_kernel(chunk):
    bh, s, p, n = 2, 128, 16, 8
    jargs, args = _inputs(bh, s, p, n, seed=chunk, decay=0.1)
    want_y, want_s = jax_kernel.ssd_chunked_pallas(*jargs, chunk=chunk, interpret=True)
    y, st = ops.ssd_chunked_scan(*args, chunk=chunk)
    _close(y, want_y, KERNEL_TOL)
    _close(st, want_s, KERNEL_TOL)
    seq_y, seq_s = ref.ssd_scan_reference(*args)
    _close(y, seq_y.numpy(), KERNEL_TOL)
    _close(st, seq_s.numpy(), KERNEL_TOL)


@pytest.mark.parametrize("s,chunk", [(200, 64), (50, 128), (129, 128)])
def test_ragged_and_short_sequences_match_reference_wrapper(s, chunk):
    """S not a multiple of the chunk (padded with loga = 0), and S shorter
    than the chunk (one chunk of S steps), as the reference's wrapper."""
    jargs, args = _inputs(3, s, 16, 8, seed=s)
    want_y, want_s = jax_ops.ssd_chunked_scan(*jargs, chunk=chunk, interpret=True)
    y, st = ops.ssd_chunked_scan(*args, chunk=chunk)
    assert y.shape == (3, s, 16) and st.shape == (3, 8, 16) and st.dtype == torch.float32
    _close(y, want_y, KERNEL_TOL)
    _close(st, want_s, KERNEL_TOL)


def test_decode_step_continues_a_prefill_state():
    """Stepping the recurrence from a chunked prefill's final state gives
    the sequential scan's next output and state; the step itself equals
    the reference's."""
    bh, s, p, n = 2, 33, 8, 4
    jargs, (xdt, loga, b, c) = _inputs(bh, s, p, n, seed=5, decay=0.3)
    y_all, s_all = ref.ssd_scan_reference(xdt, loga, b, c)
    _, s_prefix = ops.ssd_chunked_scan(xdt[:, :-1], loga[:, :-1], b[:, :-1], c[:, :-1],
                                       chunk=16)
    y_last, s_last = ref.ssd_decode_step(s_prefix, xdt[:, -1], loga[:, -1], b[:, -1],
                                         c[:, -1])
    np.testing.assert_allclose(y_last.numpy(), y_all[:, -1].numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(s_last.numpy(), s_all.numpy(), atol=2e-4, rtol=2e-4)
    jy, js = jax_ref.ssd_decode_step(jnp.asarray(s_prefix.numpy()), *(a[:, -1] for a in jargs))
    _close(y_last, jy, 1e-5)
    _close(s_last, js, 1e-5)


def test_masked_decay_does_not_overflow():
    """loga ~ -0.8 per step (Mamba2's init: A = -1, softplus(dt) ~ 0.7-0.8)
    over 128-step chunks: exp(cum_i - cum_j) above the diagonal is inf in
    float32, and must be selected away, not multiplied by 0."""
    rng = np.random.default_rng(9)
    bh, s, p, n = 2, 256, 16, 8
    xdt = torch.from_numpy(rng.standard_normal((bh, s, p)).astype(np.float32))
    loga = torch.from_numpy(-np.logaddexp(0, rng.standard_normal((bh, s))).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((bh, s, n)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((bh, s, n)).astype(np.float32))
    cum = torch.cumsum(loga[:, :128], dim=-1)
    assert torch.isinf(torch.exp(cum[:, -1] - cum[:, 0])).logical_not().all()
    assert torch.isinf(torch.exp(cum[:, 0] - cum[:, -1])).any()   # the upper triangle overflows
    y, st = ops.ssd_chunked_scan(xdt, loga, b, c, chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    seq_y, seq_s = ref.ssd_scan_reference(xdt, loga, b, c)
    _close(y, seq_y.numpy(), KERNEL_TOL)
    _close(st, seq_s.numpy(), KERNEL_TOL)


def test_cpu_tensors_take_the_plain_route():
    _, args = _inputs(2, 40, 8, 4, seed=4)
    before = ops.LAUNCHES
    y, st = ops.ssd_chunked_scan(*args, chunk=16)
    assert ops.LAUNCHES == before          # the CPU never reaches the kernel
    want_y, want_s = ref.ssd_chunked_ref(*args, chunk=16)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(st, want_s, rtol=0, atol=0)


def test_kernel_route_refuses_chunks_it_cannot_hold():
    """The kernel holds chunk 128 at N = P = 64 (Mamba2's width); its
    wrapper refuses xLSTM's 512, with the reason, before any launch."""
    assert ops.smem_bytes(128, 64, 64) <= ops.SMEM_LIMIT
    assert ops.smem_bytes(512, 64, 64) > ops.SMEM_LIMIT
    _, args = _inputs(1, 1024, 64, 64, seed=6)
    with pytest.raises(ValueError, match="chunk 512"):
        ops._launch(*args, chunk=512)
    with pytest.raises(ValueError, match="float32"):
        ops._launch(*(a.double() for a in args), chunk=128)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,p,n,chunk", [
    *[(*shape, 32) for shape in SHAPES],
    (2, 128, 16, 8, 16), (2, 128, 16, 8, 64), (2, 128, 16, 8, 128),
    (3, 200, 64, 64, 128), (2, 50, 32, 16, 128)])
def test_kernel_matches_plain_version_on_the_card(bh, s, p, n, chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(s + chunk)
    cuda = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    xdt = cuda(rng.standard_normal((bh, s, p)))
    loga = cuda(-np.logaddexp(0, rng.standard_normal((bh, s))))
    b, c = cuda(rng.standard_normal((bh, s, n))), cuda(rng.standard_normal((bh, s, n)))
    before = ops.LAUNCHES
    y, st = ops.ssd_chunked_scan(xdt, loga, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want_y, want_s = ref.ssd_chunked_ref(xdt, loga, b, c, chunk=chunk)
    torch.testing.assert_close(y, want_y, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    torch.testing.assert_close(st, want_s, atol=KERNEL_TOL, rtol=KERNEL_TOL)
