"""Dispatch for the order-pinned scoring kernel (``csrc/chain_dot.cu``).

``all_scores(phi, u)`` scores (B,) query rows against every row of phi,
``pair_scores(phi, u, cand)`` against (B, C) candidate rows; both equal
``ref.py`` (and so the NumPy oracle) bit for bit. They take tensors on the
card only: a tensor on the CPU raises, and a failed build or launch
raises. Nothing falls back to ``ref.py``; the embedding server sends CPU
tensors there itself.

``LAUNCHES`` counts kernel launches, so that a run can show it went
through them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

LAUNCHES = 0


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.chain_dot_init.argtypes = []
    lib.chain_dot_init.restype = ctypes.c_int
    lib.chain_dot_all_launch.argtypes = [ptr] * 3 + [i64] * 3 + [ptr]
    lib.chain_dot_all_launch.restype = ctypes.c_int
    lib.chain_dot_pair_launch.argtypes = [ptr] * 4 + [i64] * 4 + [ptr]
    lib.chain_dot_pair_launch.restype = ctypes.c_int
    lib.chain_dot_error_string.argtypes = [ctypes.c_int]
    lib.chain_dot_error_string.restype = ctypes.c_char_p
    _raise_on(lib, lib.chain_dot_init(), "chain_dot library init")


LIBRARY = CudaLibrary("chain_dot", Path(__file__).resolve().parent / "csrc" / "chain_dot.cu",
                      _declare)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: " + lib.chain_dot_error_string(err).decode())


def _ids(t: torch.Tensor, dim: int, dev: torch.device, name: str) -> torch.Tensor:
    if t.device != dev or t.dim() != dim or t.dtype.is_floating_point or t.dtype == torch.bool:
        raise ValueError(f"chain_dot: {name} must be a {dim}-D integer tensor on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.to(torch.int64).contiguous()


def _check_phi(phi: torch.Tensor) -> None:
    if phi.device.type != "cuda":
        raise ValueError(f"chain_dot: tensors on the card only, got phi on {phi.device} "
                         "(the CPU route is kernels.chain_dot.ref)")
    if phi.dtype != torch.float32 or phi.dim() != 2 or not phi.is_contiguous() \
            or phi.shape[1] < 1:
        raise ValueError(f"chain_dot: phi must be a contiguous (N, d >= 1) float32 tensor, "
                         f"got {phi.dtype} {tuple(phi.shape)}")


def all_scores(phi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(N, d) phi, (B,) query ids -> (B, N) scores, one launch."""
    global LAUNCHES
    _check_phi(phi)
    u = _ids(u, 1, phi.device, "u")
    n, d = phi.shape
    out = torch.empty((u.shape[0], n), dtype=torch.float32, device=phi.device)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(phi.device):
        err = lib.chain_dot_all_launch(phi.data_ptr(), u.data_ptr(), out.data_ptr(), n, d,
                                       u.shape[0], torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "chain_dot_all launch")
    LAUNCHES += 1
    return out


def pair_scores(phi: torch.Tensor, u: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(N, d) phi, (B,) query ids, (B, C) candidate ids -> (B, C) scores,
    one launch."""
    global LAUNCHES
    _check_phi(phi)
    u = _ids(u, 1, phi.device, "u")
    cand = _ids(cand, 2, phi.device, "cand")
    if cand.shape[0] != u.shape[0]:
        raise ValueError(f"chain_dot: {u.shape[0]} queries but {cand.shape[0]} candidate rows")
    n, d = phi.shape
    b, c = cand.shape
    out = torch.empty((b, c), dtype=torch.float32, device=phi.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("chain_dot: candidates of an empty phi")
    lib = LIBRARY.load()
    with torch.cuda.device(phi.device):
        err = lib.chain_dot_pair_launch(phi.data_ptr(), u.data_ptr(), cand.data_ptr(),
                                        out.data_ptr(), n, d, b, c,
                                        torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "chain_dot_pair launch")
    LAUNCHES += 1
    return out
