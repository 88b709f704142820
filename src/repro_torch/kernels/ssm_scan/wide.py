"""K3's wide route: the chunked SSD scan at head dims and states up to
1,024 and chunks up to 512 steps (``csrc/ssd_wide.cu``).

It computes what ``ops.ssd_chunked_scan`` computes (the reference
wrapper's function) for the shapes that the first route's kernels
(``csrc/ssd_scan.cu``: P and N up to 64, chunks up to 128) refuse: the
xLSTM's mLSTM scans a 512 x 513 matrix memory per head in chunks of 512.
``ops`` checks the arguments, picks the route and frames the call
(``ops.frame``); ``launch`` here takes float32 tensors on the card,
strided as the mixers pass them, and runs four kernels: cum, C B^T once
per (group, chunk), the chained chunk states, then y. ``LAUNCHES`` counts scans (four kernel launches each), so
that a run can show it went through this route.
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


def launch(xdt, loga, b, c, q: int, y, s_fin, states, dims, strides):
    """One scan on the card: xdt (B, H, S, P), loga (B, H, S), b and c (B,
    G, S, N), all float32 with a contiguous last dim, chunk q (<= S, <=
    MAX_CHUNK), P and N <= MAX_DIM; y (B, H, S, P) and the final state
    s_fin (B, H, N, P), float32, are written in place, and the state after
    each chunk into ``states``. ``ops._run`` checks the shape and frames the
    rest (``ops.frame``); a caller that forces this route at a shape the
    first one holds frames it the same way. Returns (y, s_fin)."""
    global LAUNCHES
    bsz, h, s, _ = xdt.shape
    g = b.shape[1]
    nc = -(-s // q)
    f32 = dict(dtype=torch.float32, device=xdt.device)
    cum = torch.empty(bsz * h * nc * q, **f32)
    cbt = torch.empty(bsz * g * nc * q * q, **f32)
    lib = LIBRARY.load()
    with torch.cuda.device(xdt.device):
        err = lib.ssd_wide_launch(
            xdt.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            s_fin.data_ptr(), cum.data_ptr(), cbt.data_ptr(), states.data_ptr(), dims,
            strides, torch.cuda.current_stream(xdt.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_wide kernel launch failed: "
                           + lib.ssd_wide_error_string(err).decode())
    LAUNCHES += 1
    return y, s_fin
