"""K3's wide route: the chunked SSD scan at head dims and states up to
1,024 and chunks up to 512 steps (``csrc/ssd_wide.cu``).

It computes what ``ops.ssd_chunked_scan`` computes (the reference
wrapper's function) for the shapes that the first route's kernels
(``csrc/ssd_scan.cu``: P and N up to 64, chunks up to 128) refuse: the
xLSTM's mLSTM scans a 512 x 513 matrix memory per head in chunks of 512.
``ops`` checks the arguments, picks the route and frames the call
(``ops._run_wide``); ``launch`` here takes float32 tensors on the card whose
rows start on 16 bytes (``aligned``) and runs four kernels, their products
by wgmma in 3xTF32: cum; C B^T once per (group, chunk) and every chunk's
local state, in one launch; the chain of the states along the chunks;
then y. ``LAUNCHES`` counts scans (four kernel launches each), so that a
run can show it went through this route.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

LAUNCHES = 0
MAX_CHUNK = 512          # the kernels' longest chunk
MAX_DIM = 1024           # their largest head dim P and state N


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.ssd_wide_launch.argtypes = [ptr] * 9 + [i64p, i64p, ptr]
    lib.ssd_wide_launch.restype = i32
    lib.ssd_wide_error_string.argtypes = [i32]
    lib.ssd_wide_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_wide", Path(__file__).resolve().parent / "csrc" / "ssd_wide.cu",
                      _declare)


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def is_aligned(t: torch.Tensor) -> bool:
    """Whether every row of t (its last dim, contiguous) starts on 16 bytes:
    the kernels move xdt, b, c and y as float4."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
        and all(st % 4 == 0 for st in t.stride()[:-1])


def empty_aligned(shape, device) -> torch.Tensor:
    """An uninitialised float32 tensor of ``shape`` whose rows start on 16
    bytes: a view of a buffer with the last dim padded to a multiple of 4."""
    *lead, last = shape
    return torch.empty(*lead, _round4(last), dtype=torch.float32, device=device)[..., :last]


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if its rows start on 16 bytes, else such a copy."""
    if is_aligned(t):
        return t
    out = empty_aligned(t.shape, t.device)
    out.copy_(t)
    return out


def launch(xdt, loga, b, c, q: int, y, s_fin, states, dims, strides):
    """One scan on the card: xdt (B, H, S, P), loga (B, H, S), b and c (B,
    G, S, N), all float32, xdt, b, c and y with rows on 16 bytes
    (``aligned``); chunk q (<= S, <= MAX_CHUNK), P and N <= MAX_DIM; y (B,
    H, S, P) and the final state s_fin (B, H, N, P), float32, are written in
    place, and the state after each chunk into ``states``. ``ops._run_wide``
    aligns the tensors and frames the rest (``ops.frame``). Returns (y,
    s_fin)."""
    global LAUNCHES
    if not all(is_aligned(t) for t in (xdt, b, c, y)):
        raise ValueError("ssd_wide: xdt, b, c and y need rows that start on 16 bytes "
                         "(ops._run_wide copies them so)")
    bsz, h, s, _ = xdt.shape
    g = b.shape[1]
    nc = -(-s // q)
    cum = torch.empty(bsz * h * nc * q, dtype=torch.float64, device=xdt.device)
    cb = torch.empty(bsz * g * nc * q * _round4(q), dtype=torch.float32, device=xdt.device)
    lib = LIBRARY.load()
    with torch.cuda.device(xdt.device):
        err = lib.ssd_wide_launch(
            xdt.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            s_fin.data_ptr(), cum.data_ptr(), cb.data_ptr(), states.data_ptr(), dims,
            strides, torch.cuda.current_stream(xdt.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_wide kernel launch failed: "
                           + lib.ssd_wide_error_string(err).decode())
    LAUNCHES += 1
    return y, s_fin
