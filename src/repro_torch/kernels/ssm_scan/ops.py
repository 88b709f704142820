"""Dispatch for the chunked SSD scan (Mamba2's prefill).

One function, the reference wrapper's (``kernels/ssm_scan/ops.py`` of the
JAX package): q = min(chunk, S) steps per chunk, S padded to a multiple
of q with loga = 0 and xdt = b = c = 0, y cut back to S. Two forms:

- ``ssd_chunked_scan(xdt, loga, b, c, chunk)``, the reference's: xdt
  (BH, S, P), loga (BH, S), b and c (BH, S, N) -> (y (BH, S, P), final
  state (BH, N, P) float32).
- ``ssd_scan_heads(xdt, loga, b, c, chunk)``, the Mamba2 mixer's: xdt
  (B, H, S, P) and loga (B, H, S) at any strides (the mixer passes
  transposed views of its (B, S, H, ·) tensors), b and c (B, G, S, N),
  each group's rows shared by its H / G heads (head h reads group
  h // (H / G)) -> (y (B, H, S, P), a view of a (B, S, H, P) tensor,
  final state (B, H, N, P) float32).

Tensors on the CPU expand b and c to every head and go to the plain
version (``ref.ssd_chunked_ref``). Tensors on the card go to the CUDA
kernels (the 3-D form is the case B = 1, G = BH), or the call raises:
there is no fallback from the card to the plain version. The kernels read
the ragged last chunk zero-filled, as the padding is, so the wrapper pads
nothing along S. Two routes, picked by shape:

- the first (``csrc/ssd_scan.cu``, two launches) takes a head dim P of 64
  and a state N that is a multiple of 8, up to 64, and chunks up to 128
  (zamba2's, and Mamba2's usual head dim): a smaller P, or N, is padded
  with zeros, which add nothing;
- the wide one (``wide.py``, ``csrc/ssd_wide.cu``, four launches) takes
  the larger shapes, P and N up to 1,024 and chunks up to 512 (the xLSTM's
  mLSTM: P = 513, N = 512, chunk 512); it reads xdt, b and c and writes y
  with every row on 16 bytes, through copies where they are not so.

A shape beyond both is refused. On the card each form runs inside
``plain_backward.PlainBackward``, whose backward is the plain version's
vector-Jacobian product, recomputed from the saved inputs (in the
profiler range ``PLAIN_BACKWARD``), for whichever of y and the final
state received a gradient: the gradients are exactly the plain version's
(the reference has no backward kernel).

``LAUNCHES`` counts scans run on the
first route (each is two kernel launches), ``wide.LAUNCHES`` those on the
wide one, so that a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.plain_backward import PlainBackward
from repro_torch.kernels.ssm_scan import ref, wide

LAUNCHES = 0
PLAIN_BACKWARD = "ssd_scan.plain_backward"   # the backward's range in a profiler trace
MAX_CHUNK = 128          # the kernels' longest chunk (eight 16-row blocks)
HEADS_PER_CTA = 8        # heads of one group per CTA (kHeads in the source)
HEAD_DIM = 64            # the kernels' head dim P (kP): a smaller one is padded with zeros
MAX_STATE = 64           # the kernels' largest state N (kMaxN)
SMEM_LIMIT = 232_448     # bytes of shared memory one Hopper block may use


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.ssd_chunked_launch.argtypes = [ptr] * 9 + [i64p, i64p, ptr]
    lib.ssd_chunked_launch.restype = i32
    lib.ssd_smem_bytes.argtypes = [i32] * 2
    lib.ssd_smem_bytes.restype = i32
    lib.ssd_sync_ints.argtypes = [i32] * 4
    lib.ssd_sync_ints.restype = ctypes.c_longlong
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_scan", Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
                      _declare)


def smem_bytes(q: int, n: int) -> int:
    """Shared memory of the kernels' largest CTA for chunk q and state N (a
    multiple of 8; the head dim is 64), float32: launch 1's C and B rows,
    or xdt's K-major hi / lo tiles, B's rows, the next head's xdt rows and
    each head's decay; launch 2's K-major tiles of xdt and S_{k-1}, C's
    rows, C B^T's blocks, the next head's rows and each head's cum; rows
    padded against bank conflicts, 1 KB to align the tiles. The same sums
    as ``smem_state_floats`` / ``smem_out_floats`` in the source."""
    qp, heads = -(-q // 16) * 16, HEADS_PER_CTA
    qb, r32 = qp // 16, lambda x: -(-x // 32) * 32
    state = max(2 * qp * (n + 4),
                256 + 2 * HEAD_DIM * r32(qp) + 2 * qp * (MAX_STATE + 4) + heads * qp + heads)
    out = 256 + 2 * HEAD_DIM * r32(qp) + 2 * HEAD_DIM * r32(n) + qp * (n + 4) \
        + qb * (qb + 1) * 128 + qp * (HEAD_DIM + 4) + n * (HEAD_DIM + 8) + heads * qp
    return 4 * max(state, out)


def _plain(xdt, loga, b, c, chunk):
    """The plain route of the heads form: b and c expanded to every head."""
    bsz, h, s, p = xdt.shape
    g, n = b.shape[1], b.shape[-1]
    rep = lambda t: t.repeat_interleave(h // g, dim=1).reshape(bsz * h, s, n)
    y, st = ref.ssd_chunked_ref(xdt.reshape(bsz * h, s, p), loga.reshape(bsz * h, s),
                                rep(b), rep(c), chunk=chunk)
    return y.reshape(bsz, h, s, p), st.reshape(bsz, h, n, p)


def ssd_chunked_scan(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (BH, S, P) in xdt's dtype, final state (BH, N, P) float32)."""
    if xdt.device.type == "cpu":
        return ref.ssd_chunked_ref(xdt, loga, b, c, chunk=chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunked_scan: unsupported device {xdt.device}")
    return _on_card(_launch, ref.ssd_chunked_ref, int(chunk), xdt, loga, b, c)


def ssd_scan_heads(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, H, S, P), final state (B, H, N, P) float32)."""
    if xdt.dim() != 4 or loga.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError("ssd_scan_heads: xdt, b, c must be 4-D and loga 3-D")
    bsz, h, s, p = xdt.shape
    g, n = b.shape[1], b.shape[-1]
    if tuple(loga.shape) != (bsz, h, s) or tuple(b.shape) != (bsz, g, s, n) \
            or tuple(c.shape) != (bsz, g, s, n) or g == 0 or h % g:
        raise ValueError(f"ssd_scan_heads: loga must be {(bsz, h, s)} and b, c (B, G, S, N) "
                         f"with H % G == 0, got {tuple(loga.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if xdt.device.type == "cpu":
        return _plain(xdt, loga, b, c, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan_heads: unsupported device {xdt.device}")
    return _on_card(_launch_heads, _plain, int(chunk), xdt, loga, b, c)


def _on_card(launch, plain, chunk: int, xdt, loga, b, c):
    """K3 forward (``launch``), the plain version's (``plain``) backward."""
    return PlainBackward.apply(functools.partial(launch, chunk=chunk),
                               functools.partial(plain, chunk=chunk), PLAIN_BACKWARD,
                               xdt, loga, b, c)


def _launch_heads(xdt, loga, b, c, chunk: int):
    """The heads form on the card: y written as a view of a (B, S, H, P) tensor."""
    bsz, h, s, p = xdt.shape
    y = wide.empty_aligned((bsz, s, h, p), xdt.device).transpose(1, 2)
    return _run(xdt, loga, b, c, chunk, y)


def _launch(xdt, loga, b, c, chunk: int):
    """The 3-D form on the card: one batch of BH heads, one group per head."""
    if xdt.dim() != 3 or loga.dim() != 2 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("ssd_chunked_scan: xdt, b, c must be 3-D and loga 2-D")
    bh, s, p = xdt.shape
    n = b.shape[-1]
    if tuple(loga.shape) != (bh, s) or tuple(b.shape) != (bh, s, n) \
            or tuple(c.shape) != (bh, s, n):
        raise ValueError(f"ssd_chunked_scan: loga must be {(bh, s)} and b, c {(bh, s, n)}, "
                         f"got {tuple(loga.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    y = torch.empty(bh, s, p, dtype=torch.float32, device=xdt.device)
    _, st = _run(xdt[None], loga[None], b[None], c[None], chunk, y[None])
    return y, st[0]


def frame(xdt, loga, b, c, q: int, y, states=None):
    """What each route's launcher takes besides the tensors, for chunk q
    (<= S): the final state (B, H, N, P) float32 to write; the scratch for
    the state after each chunk, (B, H, nc, N, P) float32 contiguous with nc
    = ceil(S / q), ``states`` checked or else allocated; and the dims and
    strides as the sources read them. Returns (s_fin, states, dims,
    strides)."""
    bsz, h, s, p = xdt.shape
    g, n = b.shape[1], b.shape[-1]
    nc = -(-s // q)
    s_fin = torch.empty(bsz, h, n, p, dtype=torch.float32, device=xdt.device)
    if states is None:
        states = torch.empty(bsz, h, nc, n, p, dtype=torch.float32, device=xdt.device)
    elif tuple(states.shape) != (bsz, h, nc, n, p) or states.dtype != torch.float32 \
            or not states.is_contiguous() or states.device != xdt.device:
        raise ValueError(f"ssd_chunked_scan: states must be a contiguous float32 "
                         f"{(bsz, h, nc, n, p)} tensor on {xdt.device}")
    dims = (ctypes.c_longlong * 7)(bsz, h, g, s, p, n, q)
    strides = (ctypes.c_longlong * 15)(*xdt.stride()[:3], *loga.stride(), *b.stride()[:3],
                                       *c.stride()[:3], *y.stride()[:3])
    return s_fin, states, dims, strides


def _run(xdt, loga, b, c, chunk: int, y, states=None):
    """Checks, then the scan on the card through the route that holds the
    shape: the first where P and N <= 64 and the chunk <= 128, else the
    wide one (``_run_wide``). y (B, H, S, P) float32 is written in place.
    ``states``, if given, is the kernels' scratch for the state after each
    chunk (``frame``), so that a test can read it back."""
    bsz, h, s, p = xdt.shape
    n = b.shape[-1]
    if any(t.dtype != torch.float32 for t in (xdt, loga, b, c)):
        raise ValueError("ssd_chunked_scan: the kernel takes float32 xdt, loga, b and c, got "
                         f"{xdt.dtype}, {loga.dtype}, {b.dtype}, {c.dtype}")
    if any(t.device != xdt.device for t in (loga, b, c)):
        raise ValueError("ssd_chunked_scan: xdt, loga, b and c must be on one device")
    if s == 0 or chunk <= 0:
        raise ValueError(f"ssd_chunked_scan: needs S > 0 and chunk > 0, got S={s}, "
                         f"chunk={chunk}")
    q = min(chunk, s)
    if q <= MAX_CHUNK and p <= HEAD_DIM and n <= MAX_STATE:
        pad_p, pad_n = HEAD_DIM - p, -n % 8
        need = smem_bytes(q, n + pad_n)
        if need > SMEM_LIMIT:
            raise ValueError(f"ssd_chunked_scan: chunk {q} with N={n} needs {need} bytes "
                             f"of shared memory, above the {SMEM_LIMIT} a block may use; "
                             "use a smaller chunk")
        if pad_p or pad_n:
            # Zero columns of xdt, b and c add nothing to y or the state.
            y_pad = torch.empty(bsz, h, s, HEAD_DIM, dtype=torch.float32, device=xdt.device)
            if states is not None:
                raise ValueError("ssd_chunked_scan: a states scratch needs P = "
                                 f"{HEAD_DIM} and N a multiple of 8, got P={p}, N={n}")
            _, st = _run(F.pad(xdt, (0, pad_p)), loga, F.pad(b, (0, pad_n)),
                         F.pad(c, (0, pad_n)), chunk, y_pad)
            y.copy_(y_pad[..., :p])
            return y, st[..., :n, :p].contiguous()
        xdt, b, c = wide.aligned(xdt), wide.aligned(b), wide.aligned(c)
        s_fin, states, dims, strides = frame(xdt, loga, b, c, q, y, states)
        if bsz * h == 0:
            return y, s_fin
        return _launch_first(xdt, loga, b, c, q, y, s_fin, states, dims, strides)
    if q <= wide.MAX_CHUNK and p <= wide.MAX_DIM and n <= wide.MAX_DIM:
        return _run_wide(xdt, loga, b, c, q, y, states)
    raise ValueError(f"ssd_chunked_scan: chunk {q} with P={p}, N={n} is beyond both "
                     f"routes: the first takes chunks up to {MAX_CHUNK} and P and N up "
                     f"to {HEAD_DIM}, the wide one chunks up to {wide.MAX_CHUNK} and P "
                     f"and N up to {wide.MAX_DIM}")


def _run_wide(xdt, loga, b, c, q: int, y, states=None):
    """The wide route for chunk q (<= S), as ``_run`` has checked the
    tensors: xdt, b and c are copied where their rows do not start on 16
    bytes (``wide.aligned``), and y is written through such a copy where its
    rows do not. Tests call it to force the route at shapes the first route
    holds. Returns (y, s_fin)."""
    xdt, b, c = wide.aligned(xdt), wide.aligned(b), wide.aligned(c)
    if not wide.is_aligned(y):
        out = wide.empty_aligned(y.shape, y.device)
        _, st = _run_wide(xdt, loga, b, c, q, out, states)
        y.copy_(out)
        return y, st
    s_fin, states, dims, strides = frame(xdt, loga, b, c, q, y, states)
    if y.shape[0] * y.shape[1] == 0:
        return y, s_fin
    return wide.launch(xdt, loga, b, c, q, y, s_fin, states, dims, strides)


def _launch_first(xdt, loga, b, c, q: int, y, s_fin, states, dims, strides):
    """One scan through the first route's two launches, as ``_run`` has
    checked and framed it. Returns (y, s_fin)."""
    global LAUNCHES
    bsz, h, s, _ = xdt.shape
    g = b.shape[1]
    nc, qb = -(-s // q), -(-q // 16)
    lib = LIBRARY.load()
    cbt = torch.empty(bsz * g * nc * qb * (qb + 1) * 128, dtype=torch.float32,
                      device=xdt.device)
    sync = torch.empty(lib.ssd_sync_ints(bsz, h, g, nc), dtype=torch.int32, device=xdt.device)
    with torch.cuda.device(xdt.device):
        err = lib.ssd_chunked_launch(
            xdt.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            s_fin.data_ptr(), cbt.data_ptr(), states.data_ptr(), sync.data_ptr(), dims,
            strides, torch.cuda.current_stream(xdt.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    LAUNCHES += 1
    return y, s_fin
