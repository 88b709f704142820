"""Dispatch for flash attention (online softmax, GQA-native).

``flash_attention`` takes q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D).
Tensors on the CPU go to the plain version (``ref.mha_reference``);
tensors on the card go to the CUDA library (``csrc/flash_attention.cu``),
which picks the kernel by type: bfloat16 to wgmma tiles fed by TMA,
float32 to the SIMT kernel on the FMA units. Head dims up to 128 take
one kernel per dim; 288 and 576 (MLA's latent, ``kv_lora_rank +
qk_rope_dim`` of minicpm3-4b and of deepseek-v2-lite-16b) take bf16
kernels that split O's columns between their warpgroups (two at 288,
three at 576) and, when ``v is k``, load one tile for both products. A
launch that fails raises —
there is no fallback from one kernel to the other or to the plain
version. The kernels read ragged lengths with bounds checks (SIMT) or
TMA's zero fill (wgmma), so the wrapper pads nothing. ``flash_attention``
still refuses what the reference's wrapper refuses (non-causal attention
over a key length that is not a multiple of the reference's key tile), so
the two stay interchangeable; ``attend``, the same route without that
refusal, is what the model layers call (an encoder over 300 frames).

On the card the kernel runs inside ``plain_backward.PlainBackward``:
its backward is the plain version's vector-Jacobian product,
``ref.mha_reference`` under autograd recomputed from the saved q, k and v
(in the profiler range ``PLAIN_BACKWARD``), so gradients are exactly
those of the plain forward (the reference trains on its plain attention
too, and has no backward kernel). When the caller passes k as v, the
kernel still sees one tensor, and autograd adds both uses' gradients into
it, as the plain version's graph does.

``DTensor`` arguments (``launch.steps``' mesh step runs the layers on
them) run on their local shards. On each mesh dim q, k and v are placed
as q is there when that is ``Shard(0)`` (batch) or ``Shard(1)`` (heads,
whose even split keeps every query head's KV head on its rank), and are
gathered whole otherwise (a shard of the sequence, as Megatron-SP's
activations arrive, or a partial sum): under that placement the local
computation is exact, and the result carries it.

``LAUNCHES`` counts kernel launches, so that a run can show it went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.plain_backward import PlainBackward

LAUNCHES = 0
PLAIN_BACKWARD = "flash_attention.plain_backward"   # the backward's range in a profiler trace
REF_BLOCK_K = 256                 # the reference wrapper's default key tile
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 288, 576)  # head dimensions the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([ptr] * 4 + [i32] * 9
                                           + [ctypes.c_float, ptr])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attention",
                      Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
                      _declare)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """softmax(q kᵀ · sm_scale) v per query head, the query head h reading
    KV head h // (Hq / Hkv); with ``causal``, query i sees keys
    j <= i + q_offset. sm_scale defaults to D ** -0.5. Returns q's dtype.
    Refuses non-causal attention over a key length that is not a multiple
    of the reference wrapper's key tile, as that wrapper does; ``attend``
    is the same computation without the refusal."""
    skv = k.shape[2]
    if not causal and skv % min(REF_BLOCK_K, max(skv, 1)) != 0:
        raise ValueError("non-causal flash requires Skv % block_k == 0")
    return attend(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
           sm_scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """The model layers' entry to K2 (``flash_attention``'s function) at
    every key length: the kernel reads ragged lengths itself, so a
    non-causal call over any Skv runs, as the reference's default route
    (``mha_reference`` / ``mha_chunked``) does. The plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if _is_dtensor(q, k, v):
        return _on_local_shards(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                 q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _on_card(q, k, v, bool(causal), float(sm_scale), int(q_offset))


def _is_dtensor(*ts) -> bool:
    if not any(type(t).__name__ == "DTensor" for t in ts):
        return False
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def _on_local_shards(q, k, v, **kw) -> torch.Tensor:
    """``attend`` on the local shards of DTensors (the module's
    docstring)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must all be DTensors")
    place = tuple(pl if isinstance(pl, Shard) and pl.dim in (0, 1) else Replicate()
                  for pl in q.placements)
    q, k, v = (t if t.placements == place else t.redistribute(t.device_mesh, place)
               for t in (q, k, v))
    out = attend(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, q.device_mesh, place, run_check=False)


def _on_card(q, k, v, causal: bool, sm_scale: float, q_offset: int) -> torch.Tensor:
    """K2 forward, the plain version's backward."""
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    return PlainBackward.apply(functools.partial(_launch, **kw),
                               functools.partial(ref.mha_reference, **kw), PLAIN_BACKWARD,
                               q, k, v)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous rows at a 16-byte-aligned base: the SIMT kernel loads 16
    bytes at a time, and a TMA tensor map needs that alignment."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, causal: bool, sm_scale: float, q_offset: int) -> torch.Tensor:
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D (B, H, S, D)")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k and v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(k.shape) != (b, hkv, skv, d) or tuple(v.shape) != (b, hkv, skv, d):
        raise ValueError(f"flash_attention: k and v must be {(b, hkv, skv, d)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B*Hq={b * hq} exceeds the grid's 65,535 rows")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    same = v is k           # one tile feeds both products (MLA passes its latent twice)
    q, k = _aligned(q), _aligned(k)
    v = k if same else _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, hq, hkv, sq, skv, d, int(causal), q_offset, ctypes.c_float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    LAUNCHES += 1
    return out
