"""Dispatch for the fused SGNS lifetime update.

``sgns_lifetime_batch`` takes the gathered buffers of G lifetimes. Tensors
on the CPU go to the plain version (``ref.py``); tensors on the card go to
the CUDA kernel (``csrc/sgns_lifetime.cu``), or the call raises — there is
no fallback from the card to the plain version. The kernel reads the
unpadded buffers and handles the window's edges itself, so the wrapper
pads nothing (the TPU kernel's wrapper padded the time axis by w).

``LAUNCHES`` counts kernel launches, so that a run can show it went
through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.sgns import ref

LAUNCHES = 0
SMEM_LIMIT = 232_448     # bytes of shared memory one Hopper block may use


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sgns_lifetime_launch.argtypes = [ptr] * 8 + [i32] * 6 + [ctypes.c_float, ptr]
    lib.sgns_lifetime_launch.restype = i32
    lib.sgns_lifetime_smem_bytes.argtypes = [i32] * 5
    lib.sgns_lifetime_smem_bytes.restype = ctypes.c_size_t
    lib.sgns_lifetime_max_cols.argtypes = []
    lib.sgns_lifetime_max_cols.restype = i32
    lib.sgns_lifetime_error_string.argtypes = [i32]
    lib.sgns_lifetime_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("sgns_lifetime",
                      Path(__file__).resolve().parent / "csrc" / "sgns_lifetime.cu",
                      _declare)


def sgns_lifetime_batch(
    ctx: torch.Tensor,    # (G, W, T, d) f32
    out: torch.Tensor,    # (G, W, T, d) f32
    neg: torch.Tensor,    # (G, T, K, d) f32
    valid: torch.Tensor,  # (G, W, T) bool
    lr: float,
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused lifetime update for G groups. Returns (ctx, out, neg, loss (G,))."""
    if ctx.device.type == "cpu":
        return ref.sgns_lifetime_batch_ref(ctx, out, neg, valid, lr, window)
    if ctx.device.type != "cuda":
        raise ValueError(f"sgns_lifetime_batch: unsupported device {ctx.device}")
    return _launch(ctx, out, neg, valid, float(lr), int(window))


def _launch(ctx, out, neg, valid, lr: float, window: int):
    global LAUNCHES
    g_cnt, w_cnt, t_len, dim = ctx.shape
    k = neg.shape[2]
    for name, t, shape in (("ctx", ctx, (g_cnt, w_cnt, t_len, dim)),
                           ("out", out, (g_cnt, w_cnt, t_len, dim)),
                           ("neg", neg, (g_cnt, t_len, k, dim))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != ctx.device:
            raise ValueError(f"sgns_lifetime_batch: {name} must be float32 {shape} "
                             f"on {ctx.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(valid.shape) != (g_cnt, w_cnt, t_len) or valid.device != ctx.device:
        raise ValueError(f"sgns_lifetime_batch: valid must be {(g_cnt, w_cnt, t_len)} "
                         f"on {ctx.device}, got {tuple(valid.shape)} on {valid.device}")
    lib = LIBRARY.load()
    if w_cnt + k > lib.sgns_lifetime_max_cols():
        raise ValueError(f"sgns_lifetime_batch: W + K = {w_cnt + k} exceeds "
                         f"{lib.sgns_lifetime_max_cols()} target columns")
    smem = lib.sgns_lifetime_smem_bytes(w_cnt, t_len, dim, k, window)
    if smem > SMEM_LIMIT:
        raise ValueError(f"sgns_lifetime_batch: W={w_cnt}, T={t_len}, d={dim} needs "
                         f"{smem} B of shared memory, above the {SMEM_LIMIT} B limit")
    ctx, out, neg = ctx.contiguous(), out.contiguous(), neg.contiguous()
    valid_i = valid.to(torch.int32).contiguous()
    ctx_o, out_o, neg_o = torch.empty_like(ctx), torch.empty_like(out), torch.empty_like(neg)
    loss = torch.empty(g_cnt, dtype=torch.float32, device=ctx.device)
    if g_cnt == 0:
        return ctx_o, out_o, neg_o, loss
    with torch.cuda.device(ctx.device):
        err = lib.sgns_lifetime_launch(
            ctx.data_ptr(), out.data_ptr(), neg.data_ptr(), valid_i.data_ptr(),
            ctx_o.data_ptr(), out_o.data_ptr(), neg_o.data_ptr(), loss.data_ptr(),
            g_cnt, w_cnt, t_len, dim, k, window, ctypes.c_float(lr),
            torch.cuda.current_stream(ctx.device).cuda_stream)
    if err != 0:
        raise RuntimeError("sgns_lifetime kernel launch failed: "
                           + lib.sgns_lifetime_error_string(err).decode())
    LAUNCHES += 1
    return ctx_o, out_o, neg_o, loss
