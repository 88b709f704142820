"""GQA attention (optional qk_norm), with a KV cache for serving.

The port of the JAX package's ``models/attention.py``. Training and
prefill attention go through ``kernels.flash_attention.ops.attend``, at
any key length and with or without the causal mask (an encoder's is
bidirectional): on the card that is the CUDA flash kernel (its backward
the plain version's), on the CPU its plain version. The tensors'
device picks the route; ``cfg.attn_impl`` is the reference's switch and is
not read here. Decode attends with a plain masked softmax over the whole
``max_len`` cache, as the reference's decode step does outside any kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm

Params = Dict[str, Any]


def init_attention(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype, device),
        "wk": dense_init(gen, (d, hkv, hd), dtype, device),
        "wv": dense_init(gen, (d, hkv, hd), dtype, device),
        "wo": dense_init(gen, (h, hd, d), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones(hd, dtype=dtype, device=device)}
        p["k_norm"] = {"scale": torch.ones(hd, dtype=dtype, device=device)}
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Params:
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros(batch, hkv, max_len, hd, dtype=dtype, device=device),
        "v": torch.zeros(batch, hkv, max_len, hd, dtype=dtype, device=device),
    }


def heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bhsk", x, w) as one matrix product."""
    b, s, _ = x.shape
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(b, s, h, k).transpose(1, 2)


def merge_heads(y: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bhsk,hkd->bsd", y, wo) as one matrix product."""
    b, h, s, k = y.shape
    return y.transpose(1, 2).reshape(b, s, h * k) @ wo.reshape(h * k, -1)


def attention(
    x: torch.Tensor,                 # (B, S, d)
    p: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,         # (S,)
    *,
    causal: bool = True,
    cache: Optional[Params] = None,
    cache_len: Optional[int] = None,   # tokens already cached
) -> torch.Tensor:
    """Returns y (B, S, d). Three modes:

    * train/prefill: cache=None -> full self-attention over x.
    * prefill with cache: cache given, cache_len=None -> fills cache[:, :, :S].
    * decode: cache + cache_len -> writes S new tokens at cache_len and
      attends over the whole cache, masking positions after each query.

    The cache is updated in place (the reference returns a new one): one
    cache per server wave, never copied.
    """
    s = x.shape[1]
    q = heads(x, p["wq"])
    k = heads(x, p["wk"])
    v = heads(x, p["wv"])

    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)

    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None or cache_len is None:
        if cache is not None:                       # prefill into the cache
            cache["k"][:, :, :s] = k
            cache["v"][:, :, :s] = v
        y = fa_ops.attend(q, k, v, causal=causal)
    else:
        # decode: append, then attend over the cache; the query at absolute
        # position cache_len + i sees the entries up to that position.
        kc, vc = cache["k"], cache["v"]
        kc[:, :, cache_len:cache_len + s] = k
        vc[:, :, cache_len:cache_len + s] = v
        kv_pos = torch.arange(kc.shape[2], device=x.device)
        q_pos = cache_len + torch.arange(s, device=x.device)
        y = attend_cache(q, kc, vc, q_pos[:, None] >= kv_pos[None, :])

    return merge_heads(y, p["wo"])


def attend_cache(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Hq, S, D) against a cache kc, vc (B, Hkv, T, D) with plain ops,
    in the reference's order of roundings: the grouped scores in the cache's
    dtype, float32 for the scale, ``mask`` (S, T; False hidden) and softmax,
    the weights back in the cache's dtype for their product with vc.
    Returns (B, Hq, S, D)."""
    b, hq, s, hd = q.shape
    hkv = kc.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, hd)
    scores = torch.einsum("bhgsk,bhtk->bhgst", qg, kc).to(torch.float32) * hd ** -0.5
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgst,bhtk->bhgsk", w.to(vc.dtype), vc).reshape(b, hq, s, hd)
