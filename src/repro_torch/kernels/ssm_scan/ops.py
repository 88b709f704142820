"""Dispatch for the chunked SSD scan (Mamba2's prefill).

``ssd_chunked_scan`` takes xdt (BH, S, P), loga (BH, S) and b, c
(BH, S, N) and returns (y (BH, S, P), final state (BH, N, P) float32),
with the reference wrapper's semantics (``kernels/ssm_scan/ops.py`` of
the JAX package): q = min(chunk, S) steps per chunk, S padded to a
multiple of q with loga = 0 and xdt = b = c = 0, y cut back to S.
Tensors on the CPU go to the plain version (``ref.ssd_chunked_ref``);
tensors on the card go to the CUDA kernel (``csrc/ssd_scan.cu``), or the
call raises — there is no fallback from the card to the plain version.
The kernel reads the ragged last chunk with bounds checks, zero-filled
as the padding is, so the wrapper pads nothing.

``LAUNCHES`` counts kernel launches, so that a run can show it went
through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ssm_scan import ref

LAUNCHES = 0
MAX_CHUNK = 128          # the kernel's longest chunk (its score tiles per thread)
SMEM_LIMIT = 232_448     # bytes of shared memory one Hopper block may use


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_scan", Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
                      _declare)


def smem_bytes(q: int, n: int, p: int) -> int:
    """Shared memory the kernel needs for chunk q, state N and head dim P:
    the chunk's xdt, B and C transposed (rows padded by one), the (q x q)
    masked scores (rows padded by one), the carried state and three (q,)
    vectors, all float32. The same sum as ``smem_bytes`` in the source."""
    return 4 * (q * p + 2 * n * (q + 1) + q * (q + 1) + n * p + 3 * q)


def ssd_chunked_scan(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (BH, S, P) in xdt's dtype, final state (BH, N, P) float32)."""
    if xdt.device.type == "cpu":
        return ref.ssd_chunked_ref(xdt, loga, b, c, chunk=chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunked_scan: unsupported device {xdt.device}")
    return _launch(xdt, loga, b, c, int(chunk))


def _launch(xdt, loga, b, c, chunk: int):
    global LAUNCHES
    if xdt.dim() != 3 or loga.dim() != 2 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("ssd_chunked_scan: xdt, b, c must be 3-D and loga 2-D")
    bh, s, p = xdt.shape
    n = b.shape[-1]
    if tuple(loga.shape) != (bh, s) or tuple(b.shape) != (bh, s, n) \
            or tuple(c.shape) != (bh, s, n):
        raise ValueError(f"ssd_chunked_scan: loga must be {(bh, s)} and b, c {(bh, s, n)}, "
                         f"got {tuple(loga.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    if any(t.dtype != torch.float32 for t in (xdt, loga, b, c)):
        raise ValueError("ssd_chunked_scan: the kernel takes float32 xdt, loga, b and c, got "
                         f"{xdt.dtype}, {loga.dtype}, {b.dtype}, {c.dtype}")
    if any(t.device != xdt.device for t in (loga, b, c)):
        raise ValueError("ssd_chunked_scan: xdt, loga, b and c must be on one device")
    if s == 0 or chunk <= 0:
        raise ValueError(f"ssd_chunked_scan: needs S > 0 and chunk > 0, got S={s}, "
                         f"chunk={chunk}")
    q = min(chunk, s)
    if q > MAX_CHUNK:
        raise ValueError(f"ssd_chunked_scan: chunk {q} is longer than the kernel's "
                         f"{MAX_CHUNK}; use a smaller chunk")
    need = smem_bytes(q, n, p)
    if need > SMEM_LIMIT:
        raise ValueError(f"ssd_chunked_scan: chunk {q} with N={n}, P={p} needs {need} bytes "
                         f"of shared memory, above the {SMEM_LIMIT} a block may use; "
                         "use a smaller chunk")
    xdt, loga, b, c = (t.contiguous() for t in (xdt, loga, b, c))
    y = torch.empty_like(xdt)
    s_fin = torch.empty(bh, n, p, dtype=torch.float32, device=xdt.device)
    if bh == 0:
        return y, s_fin
    lib = LIBRARY.load()
    with torch.cuda.device(xdt.device):
        err = lib.ssd_scan_launch(
            xdt.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            s_fin.data_ptr(), bh, s, p, n, q,
            torch.cuda.current_stream(xdt.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    LAUNCHES += 1
    return y, s_fin
