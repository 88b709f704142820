"""Dispatch for the fused SGNS lifetime update (K1) and the DSGL step.

``sgns_step`` runs one DSGL step on (S, N, d) replica matrices in place:
the lifetime update of every (replica, lifetime) pair on rows gathered by
id, then the duplicate-averaged write-back of the live rows.
``sgns_lifetime_batch`` is the TPU kernel's buffer interface: the update
of G lifetimes on gathered buffers. Tensors on the CPU go to the plain
versions (``ref.py``); tensors on the card go to the CUDA kernels
(``csrc/sgns_lifetime.cu``), or the call raises: there is no fallback from
the card to the plain version. One kernel serves both: it reads rows by
id, and the buffer interface hands it identity ids into the buffers.

``LAUNCHES`` counts launches of the lifetime kernel and ``WRITEBACKS``
launches of the write-back, so that a run can show it went through both;
a CUDA graph that replays C steps adds C to each (``core.dsgl.ChunkGraphs``).
The write-back adds each row's deltas in the reference's slot order, so a
step is bit-for-bit repeatable on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.sgns import ref

LAUNCHES = 0
WRITEBACKS = 0
SMEM_LIMIT = 232_448     # bytes of shared memory one Hopper block may use


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sgns_init.argtypes = []
    lib.sgns_init.restype = i32
    lib.sgns_lifetime_launch.argtypes = ([ptr] * 5 + [i64, i32] + [ptr] * 5
                                         + [i32] * 6 + [ptr])
    lib.sgns_lifetime_launch.restype = i32
    lib.sgns_wb_keys_launch.argtypes = [ptr] * 5 + [i32] * 5 + [i64, i64, ptr]
    lib.sgns_wb_keys_launch.restype = i32
    lib.sgns_wb_segs_len.argtypes = [i32] * 4
    lib.sgns_wb_segs_len.restype = i64
    lib.sgns_wb_segments_launch.argtypes = [ptr] * 9 + [i32] * 5 + [i64, ptr]
    lib.sgns_wb_segments_launch.restype = i32
    lib.sgns_lifetime_smem_bytes.argtypes = [i32] * 5
    lib.sgns_lifetime_smem_bytes.restype = ctypes.c_size_t
    for name in ("sgns_lifetime_max_cols", "sgns_lifetime_max_ring",
                 "sgns_lifetime_max_dim", "sgns_lifetime_prefetch"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.sgns_lifetime_error_string.argtypes = [i32]
    lib.sgns_lifetime_error_string.restype = ctypes.c_char_p
    err = lib.sgns_init()
    if err != 0:
        raise RuntimeError("sgns_lifetime library init failed: "
                           + lib.sgns_lifetime_error_string(err).decode())


LIBRARY = CudaLibrary("sgns_lifetime",
                      Path(__file__).resolve().parent / "csrc" / "sgns_lifetime.cu",
                      _declare)


@dataclasses.dataclass
class StepScratch:
    """Where the lifetime kernel writes one step's deltas (live slots only)
    and per-lifetime losses, and where the write-back sorts its keys: one
    per slot, S G W T context slots, then as many target slots, then
    S G T K negative slots. Made on the card (the long-segment list's
    length comes from the kernel library)."""

    d_ctx: torch.Tensor   # (S, G, W, T, d)
    d_out: torch.Tensor   # (S, G, W, T, d)
    d_neg: torch.Tensor   # (S, G, T, K, d)
    loss: torch.Tensor    # (S * G,)
    keys: torch.Tensor    # (2 S G W T + S G T K,) int32
    sorted: torch.Tensor  # the keys, sorted stably
    slot_of: torch.Tensor  # int64: the slot of each sorted key
    dead: torch.Tensor    # (S G T K,) uint8: a negative at a position with no token
    segs: torch.Tensor    # int64: the long segments' count, then (start, end) pairs

    @classmethod
    def empty(cls, walks_shape, negatives: int, dim: int, device) -> "StepScratch":
        s, g, w, t = walks_shape
        f = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
        n_keys = 2 * s * g * w * t + s * g * t * negatives
        i = lambda dtype, n=n_keys: torch.empty(n, dtype=dtype, device=device)
        segs = LIBRARY.load().sgns_wb_segs_len(s * g, w, t, negatives)
        return cls(f(s, g, w, t, dim), f(s, g, w, t, dim), f(s, g, t, negatives, dim), f(s * g),
                   i(torch.int32), i(torch.int32), i(torch.int64),
                   i(torch.uint8, s * g * t * negatives), i(torch.int64, segs))


def _check_kernel_shape(lib, w_cnt: int, t_len: int, dim: int, k: int, window: int,
                        what: str) -> None:
    if w_cnt + k > lib.sgns_lifetime_max_cols():
        raise ValueError(f"{what}: W + K = {w_cnt + k} exceeds "
                         f"{lib.sgns_lifetime_max_cols()} target columns")
    if dim % 4 or dim > lib.sgns_lifetime_max_dim():
        raise ValueError(f"{what}: d = {dim} must be a multiple of 4 and at most "
                         f"{lib.sgns_lifetime_max_dim()}")
    if window < 1 or w_cnt * (2 * window + 1 + lib.sgns_lifetime_prefetch()) \
            > lib.sgns_lifetime_max_ring():
        raise ValueError(f"{what}: W = {w_cnt}, window = {window} needs more than "
                         f"{lib.sgns_lifetime_max_ring()} ring slots")
    smem = lib.sgns_lifetime_smem_bytes(w_cnt, t_len, dim, k, window)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: W={w_cnt}, T={t_len}, d={dim}, K={k} needs {smem} B "
                         f"of shared memory, above the {SMEM_LIMIT} B limit")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.sgns_lifetime_error_string(err).decode())


def _lifetimes(lib, ctx_src, out_src, neg_src, walk_ids, neg_ids, rep_rows: int,
               per_rep: int, scratch: StepScratch, lr: torch.Tensor, window: int) -> None:
    """One launch of the lifetime kernel over every lifetime of walk_ids."""
    global LAUNCHES
    w_cnt, t_len = walk_ids.shape[-2:]
    n_life = walk_ids.numel() // (w_cnt * t_len)
    k = neg_ids.shape[-1]
    dim = ctx_src.shape[-1]
    if n_life == 0:
        scratch.loss.zero_()
        return
    err = lib.sgns_lifetime_launch(
        ctx_src.data_ptr(), out_src.data_ptr(), neg_src.data_ptr(),
        walk_ids.data_ptr(), neg_ids.data_ptr(), rep_rows, per_rep,
        scratch.d_ctx.data_ptr(), scratch.d_out.data_ptr(), scratch.d_neg.data_ptr(),
        scratch.loss.data_ptr(), lr.data_ptr(), n_life, w_cnt, t_len, dim, k, window,
        torch.cuda.current_stream(ctx_src.device).cuda_stream)
    _raise_on(lib, err, "sgns_lifetime kernel")
    LAUNCHES += 1


# ---------------------------------------------------------------------------
# The DSGL step
# ---------------------------------------------------------------------------


def sgns_step(phi_in: torch.Tensor, phi_out: torch.Tensor, walks: torch.Tensor,
              negs: torch.Tensor, lr: torch.Tensor, window: int) -> torch.Tensor:
    """One DSGL step over S replicas, phi updated in place.

    phi_in, phi_out (S, N, d) f32; walks (S, G, W, T) ids, -1 = no token;
    negs (S, G, T, K) ids; lr a one-element f32 tensor on phi's device.
    Returns the loss per replica (S,)."""
    if phi_in.device.type == "cpu":
        return ref.sgns_step_ref(phi_in, phi_out, walks, negs, lr, window)
    if phi_in.device.type != "cuda":
        raise ValueError(f"sgns_step: unsupported device {phi_in.device}")
    s_cnt, g_cnt = walks.shape[:2]
    scratch = StepScratch.empty(walks.shape, negs.shape[-1], phi_in.shape[-1], phi_in.device)
    launch_step(phi_in, phi_out, walks, negs, lr, window, scratch)
    return scratch.loss.view(s_cnt, g_cnt).sum(dim=1)


def _check_step_args(phi_in, phi_out, walks, negs, lr, window: int, what: str):
    """Raise unless the step's arguments are what the kernels take; returns
    the loaded library."""
    s_cnt, n_rows, dim = phi_in.shape
    _, g_cnt, w_cnt, t_len = walks.shape
    k = negs.shape[-1]
    dev = phi_in.device
    for name, t, shape, dtype in (
            ("phi_in", phi_in, (s_cnt, n_rows, dim), torch.float32),
            ("phi_out", phi_out, (s_cnt, n_rows, dim), torch.float32),
            ("walks", walks, (s_cnt, g_cnt, w_cnt, t_len), torch.int32),
            ("negs", negs, (s_cnt, g_cnt, t_len, k), torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if lr.dtype != torch.float32 or lr.numel() != 1 or lr.device != dev:
        raise ValueError(f"{what}: lr must be one float32 on {dev}, got "
                         f"{lr.dtype} {tuple(lr.shape)} on {lr.device}")
    lib = LIBRARY.load()
    _check_kernel_shape(lib, w_cnt, t_len, dim, k, window, what)
    return lib


def launch_step(phi_in, phi_out, walks, negs, lr, window: int, scratch: StepScratch) -> None:
    """The step's kernels on the card, on the current stream: the lifetime
    kernel, then the write-back. Per-lifetime losses land in
    ``scratch.loss``. Issues no host synchronisation and keeps no state
    between steps, so a CUDA graph can capture it and a step that fails
    leaves nothing for the next."""
    lib = _check_step_args(phi_in, phi_out, walks, negs, lr, window, "sgns_step")
    with torch.cuda.device(phi_in.device):
        _lifetimes(lib, phi_in, phi_out, phi_out, walks, negs, phi_in.shape[1], walks.shape[1],
                   scratch, lr, window)
        write_back(phi_in, phi_out, walks, negs, scratch)


def write_back(phi_in, phi_out, walks, negs, scratch: StepScratch) -> None:
    """The step's write-back on the card, on the current stream: each live
    slot's delta in ``scratch`` (as the lifetime kernel leaves them) into
    phi_in / phi_out, duplicates averaged, each row's deltas added in the
    reference's slot order (``ref.write_back_ref`` is the plain version).
    The slots' keys, their stable sort (a library sort), then the row
    segments (short ones eight lanes each, long ones a CTA each);
    ``WRITEBACKS`` counts the write-backs."""
    global WRITEBACKS
    s_cnt, n_rows, dim = phi_in.shape
    _, g_cnt, w_cnt, t_len = walks.shape
    k = negs.shape[-1]
    n_life, rows = s_cnt * g_cnt, s_cnt * n_rows
    if n_life == 0:
        return
    if 2 * rows >= 2**31 - 1:
        raise ValueError(f"write-back: {s_cnt} x {n_rows} rows exceed its int32 keys")
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(phi_in.device).cuda_stream
    with torch.cuda.device(phi_in.device):
        _raise_on(lib, lib.sgns_wb_keys_launch(
            walks.data_ptr(), negs.data_ptr(), scratch.keys.data_ptr(), scratch.dead.data_ptr(),
            scratch.segs.data_ptr(), n_life, w_cnt, t_len, k, g_cnt, n_rows, rows, stream),
            "sgns write-back keys")
        torch.sort(scratch.keys, stable=True, out=(scratch.sorted, scratch.slot_of))
        _raise_on(lib, lib.sgns_wb_segments_launch(
            phi_in.data_ptr(), phi_out.data_ptr(), scratch.sorted.data_ptr(),
            scratch.slot_of.data_ptr(), scratch.dead.data_ptr(), scratch.d_ctx.data_ptr(),
            scratch.d_out.data_ptr(), scratch.d_neg.data_ptr(), scratch.segs.data_ptr(), n_life,
            w_cnt, t_len, dim, k, rows, stream), "sgns write-back")
    WRITEBACKS += 1


def lifetime_deltas(phi_in, phi_out, walks, negs, lr, window: int,
                    scratch: StepScratch = None) -> StepScratch:
    """The lifetime kernel alone on rows of phi gathered by id (phi
    unchanged): each live slot's delta and each lifetime's loss, the
    function ``ref.lifetime_deltas_ref`` computes, which gives every slot a
    delta, zero where the slot is dead. Without ``scratch``, a zeroed one is
    made; a given one keeps what its dead slots hold. For checks and
    measurement."""
    lib = _check_step_args(phi_in, phi_out, walks, negs, lr, window, "lifetime_deltas")
    if scratch is None:
        scratch = StepScratch.empty(walks.shape, negs.shape[-1], phi_in.shape[-1],
                                    phi_in.device)
        for t in (scratch.d_ctx, scratch.d_out, scratch.d_neg):
            t.zero_()
    with torch.cuda.device(phi_in.device):
        _lifetimes(lib, phi_in, phi_out, phi_out, walks, negs, phi_in.shape[1],
                   walks.shape[1], scratch, lr, window)
    return scratch


# ---------------------------------------------------------------------------
# The TPU kernel's buffer interface
# ---------------------------------------------------------------------------


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
    g_cnt, w_cnt, t_len, dim = ctx.shape
    k = neg.shape[2]
    dev = ctx.device
    for name, t, shape in (("ctx", ctx, (g_cnt, w_cnt, t_len, dim)),
                           ("out", out, (g_cnt, w_cnt, t_len, dim)),
                           ("neg", neg, (g_cnt, t_len, k, dim))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"sgns_lifetime_batch: {name} must be float32 {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(valid.shape) != (g_cnt, w_cnt, t_len) or valid.device != dev:
        raise ValueError(f"sgns_lifetime_batch: valid must be {(g_cnt, w_cnt, t_len)} "
                         f"on {dev}, got {tuple(valid.shape)} on {valid.device}")
    lib = LIBRARY.load()
    _check_kernel_shape(lib, w_cnt, t_len, dim, k, window, "sgns_lifetime_batch")
    ctx, out, neg = ctx.contiguous(), out.contiguous(), neg.contiguous()
    # Row r of each buffer is slot r: identity ids, -1 where the token is invalid.
    slot = torch.arange(g_cnt * w_cnt * t_len, dtype=torch.int32, device=dev)
    walk_ids = torch.where(valid.reshape(-1).to(torch.bool), slot, -1).view(g_cnt, w_cnt, t_len)
    neg_ids = torch.arange(g_cnt * t_len * k, dtype=torch.int32,
                           device=dev).view(g_cnt, t_len, k)
    scratch = StepScratch.empty((1, g_cnt, w_cnt, t_len), k, dim, dev)
    for t in (scratch.d_ctx, scratch.d_out, scratch.d_neg):
        t.zero_()      # dead slots keep their rows
    lr_t = torch.full((1,), lr, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _lifetimes(lib, ctx.view(-1, dim), out.view(-1, dim), neg.view(-1, dim), walk_ids,
                   neg_ids, 0, max(g_cnt, 1), scratch, lr_t, window)
    return (ctx + scratch.d_ctx[0], out + scratch.d_out[0], neg + scratch.d_neg[0],
            scratch.loss)
