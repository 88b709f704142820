"""The chunked SSD scan (Mamba2): the port's plain versions and wrapper
against the JAX reference's ``ssd_scan_reference``, ``ssd_chunked_ref``,
``ssd_decode_step``, its Pallas kernel (interpret mode) and its wrapper,
on the shapes and tolerances of the reference's own kernel tests: 2e-3
for the chunked form against the sequential scan, 3e-3 for the kernel.
The mixer's form (``ssd_scan_heads``: strided (B, H, S, ·) views, B and C
per group) is held against the Pallas kernel fed broadcast B and C, and
the plain versions of the kernels' two launches, composed, against
``ssd_chunked_ref`` (1e-5: the same float32 products summed in another
order). The CUDA kernels run only on the card (``-m cuda``); there the
chunk states they pass from CTA to CTA are held against launch 1's plain
version, and the chain is run many times on fresh inputs."""

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

CHUNKED_TOL, KERNEL_TOL, PHASES_TOL = 2e-3, 3e-3, 1e-5
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
    """The first route holds chunk 128 at N = P = 64 (Mamba2's width), not
    the xLSTM's 512, which goes to the wide route; a chunk beyond the wide
    route's 512 is refused, with the reason, before any launch."""
    assert ops.smem_bytes(128, 64) <= ops.SMEM_LIMIT
    assert ops.smem_bytes(512, 64) > ops.SMEM_LIMIT
    _, args = _inputs(1, 1024, 64, 64, seed=6)
    with pytest.raises(ValueError, match="chunk 1024"):
        ops._launch(*args, chunk=1024)
    with pytest.raises(ValueError, match="float32"):
        ops._launch(*(a.double() for a in args), chunk=128)


def _heads_inputs(bsz, h, g, s, p, n, seed, model_decay=False):
    """The mixer's layout, from numpy: xdt (B, S, H, P) and loga (B, S, H)
    seen as (B, H, S, ·) views, b and c (B, G, S, N) distinct per group;
    loga ~ -U(0, 0.2), or -softplus(N(0, 1)) as the mixer draws it at init."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    if model_decay:
        loga = -np.logaddexp(0, rng.standard_normal((bsz, s, h))).astype(np.float32)
    else:
        loga = (-rng.uniform(size=(bsz, s, h)) * 0.2).astype(np.float32)
    b = rng.standard_normal((bsz, g, s, n)).astype(np.float32)
    c = rng.standard_normal((bsz, g, s, n)).astype(np.float32)
    return xdt, loga, b, c


def _broadcast_3d(xdt, loga, b, c):
    """The reference's (BH, S, ·) form of the mixer's inputs: head h reads
    group h // (H / G)."""
    bsz, s, h, p = xdt.shape
    rep = lambda t: np.repeat(t, h // t.shape[1], axis=1).reshape(bsz * h, s, -1)
    return (xdt.transpose(0, 2, 1, 3).reshape(bsz * h, s, p),
            loga.transpose(0, 2, 1).reshape(bsz * h, s), rep(b), rep(c))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s,chunk", [(200, 32), (150, 128)])
def test_heads_form_matches_pallas_kernel(g, s, chunk):
    """The mixer's form (strided views, B and C per group, ragged S) against
    the reference's Pallas kernel (interpret mode, through its padding
    wrapper) fed B and C broadcast to every head."""
    bsz, h, p, n = 2, 4, 16, 8
    xdt, loga, b, c = _heads_inputs(bsz, h, g, s, p, n, seed=g + s)
    want_y, want_s = jax_ops.ssd_chunked_scan(
        *(jnp.asarray(a) for a in _broadcast_3d(xdt, loga, b, c)), chunk=chunk,
        interpret=True)
    before = ops.LAUNCHES
    y, st = ops.ssd_scan_heads(torch.from_numpy(xdt).transpose(1, 2),
                               torch.from_numpy(loga).transpose(1, 2), torch.from_numpy(b),
                               torch.from_numpy(c), chunk=chunk)
    assert ops.LAUNCHES == before
    assert y.shape == (bsz, h, s, p) and st.shape == (bsz, h, n, p)
    _close(y.reshape(bsz * h, s, p), want_y, KERNEL_TOL)
    _close(st.reshape(bsz * h, n, p), want_s, KERNEL_TOL)


def test_heads_form_refuses_heads_not_split_into_groups():
    xdt, loga, b, c = (torch.from_numpy(a) for a in _heads_inputs(1, 3, 2, 16, 8, 8, seed=1))
    with pytest.raises(ValueError, match="H % G"):
        ops.ssd_scan_heads(xdt.transpose(1, 2), loga.transpose(1, 2), b, c, chunk=8)


@pytest.mark.parametrize("bh,s,p,n,chunk", [(*shape, 32) for shape in SHAPES]
                         + [(3, 200, 16, 8, 128), (2, 50, 8, 16, 16)])
def test_phases_compose_to_chunked_ref(bh, s, p, n, chunk):
    """Launch 1's plain version (cum, C B^T, the state after each chunk)
    and launch 2's (y), composed, give ``ssd_chunked_ref``; the states are
    the chunked scan's states at the chunk boundaries."""
    _, args = _inputs(bh, s, p, n, seed=s + chunk)
    y, st = ref.ssd_chunked_phases_ref(*args, chunk=chunk)
    want_y, want_s = ref.ssd_chunked_ref(*args, chunk=chunk)
    torch.testing.assert_close(y, want_y, atol=PHASES_TOL, rtol=PHASES_TOL)
    torch.testing.assert_close(st, want_s, atol=PHASES_TOL, rtol=PHASES_TOL)
    q = min(chunk, s)
    _, _, states = ref.ssd_chunk_state_ref(*args, chunk=chunk)
    assert states.shape == (bh, -(-s // q), n, p)
    xdt, loga, b, c = args
    _, s_one = ref.ssd_chunked_ref(xdt[:, :q], loga[:, :q], b[:, :q], c[:, :q], chunk=chunk)
    torch.testing.assert_close(states[:, 0], s_one, atol=PHASES_TOL, rtol=PHASES_TOL)
    torch.testing.assert_close(states[:, -1], want_s, atol=PHASES_TOL, rtol=PHASES_TOL)


@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 300, 97, 96, 256), (1, 600, 100, 36, 512), (3, 130, 12, 130, 64),
    (1, 700, 513, 512, 512)])                # the mLSTM's width, a ragged second chunk
def test_local_states_and_chain_compose_to_chunked_ref(bh, s, p, n, chunk):
    """The wide route's split of the state phase at wide shapes, with the
    mixer's decay (-softplus(N(0, 1)), so that exp(cum) underflows over a
    long chunk): each chunk's local state is the state that chunk alone
    leaves from a zero state (``ssd_chunked_ref`` over its steps), the
    elementwise chain of the local states gives the chunked scan's state
    at every chunk boundary, and the phases composed give
    ``ssd_chunked_ref``."""
    rng = np.random.default_rng(s + p)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((bh, s, p)), -np.logaddexp(0, rng.standard_normal((bh, s))),
        rng.standard_normal((bh, s, n)) / np.sqrt(n), rng.standard_normal((bh, s, n)))]
    xdt, loga, b, c = args
    q = min(chunk, s)
    cum, local = ref.ssd_chunk_local_ref(xdt, loga, b, chunk)
    states = ref.ssd_state_chain_ref(cum, local)
    for k in range(-(-s // q)):
        sl = slice(k * q, min(s, (k + 1) * q))
        _, alone = ref.ssd_chunked_ref(xdt[:, sl], loga[:, sl], b[:, sl], c[:, sl], chunk=q)
        torch.testing.assert_close(local[:, k], alone, atol=PHASES_TOL, rtol=PHASES_TOL)
        _, upto = ref.ssd_chunked_ref(xdt[:, :sl.stop], loga[:, :sl.stop], b[:, :sl.stop],
                                      c[:, :sl.stop], chunk=q)
        torch.testing.assert_close(states[:, k], upto, atol=PHASES_TOL, rtol=PHASES_TOL)
    y, st = ref.ssd_chunked_phases_ref(*args, chunk=chunk)
    want_y, want_s = ref.ssd_chunked_ref(*args, chunk=chunk)
    torch.testing.assert_close(y, want_y, atol=PHASES_TOL, rtol=PHASES_TOL)
    torch.testing.assert_close(st, want_s, atol=PHASES_TOL, rtol=PHASES_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,p,n,chunk", [
    *[(*shape, 32) for shape in SHAPES],
    (2, 128, 16, 8, 16), (2, 128, 16, 8, 64), (2, 128, 16, 8, 128),
    (3, 200, 64, 64, 128), (2, 50, 32, 16, 128), (2, 40, 12, 4, 16)])
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


def _cuda(*arrays):
    return [torch.from_numpy(a).cuda() for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,h,g,s,p,n,chunk", [
    (4, 112, 1, 1819, 64, 64, 128),      # zamba2-7b's prefill wave
    (2, 8, 2, 300, 64, 64, 128), (2, 6, 3, 200, 32, 16, 32), (1, 4, 2, 77, 24, 8, 50)])
def test_heads_form_matches_plain_version_on_the_card(bsz, h, g, s, p, n, chunk):
    """The mixer's form on the card, with the mixer's decay (-softplus(N(0,
    1)), ~-0.8 a step, so that the masked decay overflows above a 128-step
    chunk's diagonal), against the plain route on the same tensors. Groups
    G > 1 have distinct B and C, so a kernel reading another head's group
    fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    xdt, loga, b, c = _cuda(*_heads_inputs(bsz, h, g, s, p, n, seed=s + g, model_decay=True))
    args = (xdt.transpose(1, 2), loga.transpose(1, 2), b, c)
    before = ops.LAUNCHES
    y, st = ops.ssd_scan_heads(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert y.transpose(1, 2).is_contiguous()         # written in the mixer's (B, S, H, P)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    want_y, want_s = ops._plain(*args, chunk=chunk)
    torch.testing.assert_close(y, want_y, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    torch.testing.assert_close(st, want_s, atol=KERNEL_TOL, rtol=KERNEL_TOL)


def _heads_run(xdt, loga, b, c, chunk):
    """The mixer's form through the route's launches, with the chunk-state
    scratch filled with NaN first and returned: a chunk that reads a state
    its predecessor has not written yet reads NaN, not a stale value that an
    earlier call on the same inputs left in reused memory."""
    bsz, h, s, p = xdt.shape
    nc = -(-s // min(chunk, s))
    y = torch.empty(bsz, s, h, p, device=xdt.device).transpose(1, 2)
    states = torch.full((bsz, h, nc, b.shape[-1], p), float("nan"), device=xdt.device)
    y, st = ops._run(xdt, loga, b, c, chunk, y, states=states)
    return y, st, states


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,h,g,s,chunk", [
    (4, 112, 1, 1819, 128), (2, 16, 2, 1000, 64), (1, 8, 1, 300, 32)])
def test_chunk_states_match_launch_one_plain_version_on_the_card(bsz, h, g, s, chunk):
    """The state after each chunk that launch 1's CTAs pass along the
    sequence (the kernels' ``states`` scratch), against
    ``ref.ssd_chunk_state_ref`` on B and C broadcast to every head."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    xdt, loga, b, c = _cuda(*_heads_inputs(bsz, h, g, s, 64, 64, seed=s + h, model_decay=True))
    args = (xdt.transpose(1, 2), loga.transpose(1, 2), b, c)
    _, _, states = _heads_run(*args, chunk=chunk)
    torch.cuda.synchronize()
    rep = lambda t: t.repeat_interleave(h // g, dim=1).reshape(bsz * h, s, 64)
    _, _, want = ref.ssd_chunk_state_ref(args[0].reshape(bsz * h, s, 64),
                                         args[1].reshape(bsz * h, s), rep(b), rep(c), chunk)
    torch.testing.assert_close(states.reshape(want.shape), want, atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,h,g,s,chunk,reps", [
    (4, 112, 1, 1819, 128, 10),        # zamba2-7b's prefill wave: 840 state CTAs in waves
    (1, 8, 1, 8192, 128, 40),          # 64 chunks of one head group, every CTA resident at once
    (1, 16, 2, 4096, 64, 40)])         # two groups, two head groups each, 64 chunks
def test_chunk_chain_holds_on_fresh_inputs_on_the_card(bsz, h, g, s, chunk, reps):
    """Launch 1's CTAs wait, head by head, for the previous chunk's CTA to
    publish that head's state. Run the mixer's form many times on fresh
    inputs, the chunk-state scratch NaN-filled each time, against the plain
    route: a chunk that went on before its predecessor's state was out
    gives NaN or a wrong y and final state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(s + h)
    for _ in range(reps):
        xdt = torch.randn(bsz, s, h, 64, device="cuda", generator=gen).transpose(1, 2)
        loga = -torch.nn.functional.softplus(
            torch.randn(bsz, s, h, device="cuda", generator=gen)).transpose(1, 2)
        b, c = (torch.randn(bsz, g, s, 64, device="cuda", generator=gen) for _ in range(2))
        y, st, _ = _heads_run(xdt, loga, b, c, chunk)
        want_y, want_s = ops._plain(xdt, loga, b, c, chunk=chunk)
        torch.testing.assert_close(y, want_y, atol=KERNEL_TOL, rtol=KERNEL_TOL)
        torch.testing.assert_close(st, want_s, atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.cuda
def test_smem_sizes_match_the_library():
    """The wrapper's shared-memory sum is the kernels' own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    lib = ops.LIBRARY.load()
    for q, n in [(128, 64), (50, 16), (16, 8), (128, 8), (96, 24), (512, 64)]:
        assert lib.ssd_smem_bytes(q, n) == ops.smem_bytes(q, n), (q, n)
