"""MLA: multi-head latent attention (MiniCPM3, DeepSeek-V2), absorbed form.

The port of the JAX package's ``models/mla.py``. Keys and values are
compressed to a ``kv_lora_rank`` latent c_kv plus one RoPE key of
``qk_rope_dim`` shared by every head; each head's W_uk is folded into its
query and its W_uv into its output:

    score_h = (q_nope_h W_uk_h^T) . c_kv  +  q_rope_h . k_rope
    y_h     = (softmax(score_h) . c_kv) W_uv_h

So attention is MQA against [c_kv | k_rope]: one KV head of dim
kv_lora_rank + qk_rope_dim (288 for minicpm3-4b), scaled by
(qk_nope_dim + qk_rope_dim) ** -0.5. The cache holds only
{"ckv": (B, max_len, kv_lora_rank), "krope": (B, max_len, qk_rope_dim)},
the sequence on axis 1 as in the reference, and is updated in place.

Prefill goes through ``kernels.flash_attention.ops.attend`` (K2) with k
itself as v. The reference's v is c_kv zero-padded to k's width and keeps
y[..., :kv_lora_rank]; P.V is column by column, so those columns are the
same sums, and on the card one tile then feeds both products. With
``attn_impl="ref"`` the reference's prefill takes ``mha_reference`` (P in
float32) up to 2,048 positions and ``mha_chunked`` (P in the model dtype)
beyond; the port's CPU route is ``mha_reference``, and its bf16 kernel
rounds P to bf16 as ``mha_chunked`` does. Decode is plain ops over the
whole cache in the reference's order of roundings: the scores in the
model dtype, then float32 for the scale, mask and softmax, the weights
back in the cache's dtype for their product with c_kv. The per-head
products around the attention are plain matrix products, as the
reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.attention import heads
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, init_rmsnorm, rmsnorm

Params = Dict[str, Any]


def init_mla(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    qn, qr = cfg.qk_nope_dim, cfg.qk_rope_dim
    vh, rank = cfg.v_head_dim, cfg.kv_lora_rank
    p: Params = {}
    if cfg.q_lora_rank:
        p["wq_down"] = dense_init(gen, (d, cfg.q_lora_rank), dtype, device)
        p["q_norm"] = init_rmsnorm(cfg.q_lora_rank, dtype, device)
        p["wq_up"] = dense_init(gen, (cfg.q_lora_rank, h, qn + qr), dtype, device)
    else:
        p["wq"] = dense_init(gen, (d, h, qn + qr), dtype, device)
    p["wkv_down"] = dense_init(gen, (d, rank), dtype, device)
    p["kv_norm"] = init_rmsnorm(rank, dtype, device)
    p["wk_rope"] = dense_init(gen, (d, qr), dtype, device)
    p["wk_up"] = dense_init(gen, (rank, h, qn), dtype, device)
    p["wv_up"] = dense_init(gen, (rank, h, vh), dtype, device)
    p["wo"] = dense_init(gen, (h, vh, d), dtype, device)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Params:
    return {
        "ckv": torch.zeros(batch, max_len, cfg.kv_lora_rank, dtype=dtype, device=device),
        "krope": torch.zeros(batch, max_len, cfg.qk_rope_dim, dtype=dtype, device=device),
    }


def _queries(x, p: Params, cfg: ModelConfig, positions):
    """(q_nope, q_rope), each (B, H, S, ·): through the q_lora bottleneck
    (``wq_down``, RMSNorm, ``wq_up``) when q_lora_rank > 0, else ``wq``;
    rope on the last qk_rope_dim columns."""
    if cfg.q_lora_rank:
        q = heads(rmsnorm(x @ p["wq_down"], p["q_norm"], cfg.norm_eps), p["wq_up"])
    else:
        q = heads(x, p["wq"])
    qn = q[..., :cfg.qk_nope_dim]
    qr = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return qn, qr


def mla_attention(
    x: torch.Tensor,                 # (B, S, d)
    p: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,         # (S,)
    *,
    cache: Optional[Params] = None,
    cache_len: Optional[int] = None,   # tokens already cached
) -> torch.Tensor:
    """Returns y (B, S, d), in the modes of ``attention.attention``:
    prefill (no ``cache_len``; fills cache[:, :S] when a cache is given)
    through flash attention, causal; decode (``cache_len``) writes S new
    latents at cache_len and attends over the whole cache, masking the
    positions after each query."""
    b, s, _ = x.shape
    rank = cfg.kv_lora_rank
    qn, qr = _queries(x, p, cfg, positions)
    ckv = rmsnorm(x @ p["wkv_down"], p["kv_norm"], cfg.norm_eps)               # (B, S, rank)
    krope = apply_rope((x @ p["wk_rope"])[:, None], positions, cfg.rope_theta)[:, 0]
    # Absorb W_uk into the query: q_lat = q_nope W_uk^T, (B, H, S, rank).
    q_lat = torch.matmul(qn, p["wk_up"].permute(1, 2, 0))
    q_mqa = torch.cat([q_lat, qr], dim=-1)                                    # (B, H, S, rank + rope)
    sm_scale = float(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5

    if cache is not None and cache_len is not None:
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        ckv_c[:, cache_len:cache_len + s] = ckv
        kr_c[:, cache_len:cache_len + s] = krope
        k_mqa = torch.cat([ckv_c, kr_c], dim=-1)                             # (B, T, rank + rope)
        scores = torch.einsum("bhsk,btk->bhst", q_mqa, k_mqa).to(torch.float32) * sm_scale
        kv_pos = torch.arange(k_mqa.shape[1], device=x.device)
        q_pos = cache_len + torch.arange(s, device=x.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = torch.where(mask[None, None], scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(ckv_c.dtype)
        y_lat = torch.einsum("bhst,btr->bhsr", w, ckv_c)
    else:
        if cache is not None:
            cache["ckv"][:, :s] = ckv
            cache["krope"][:, :s] = krope
        k_mqa = torch.cat([ckv, krope], dim=-1)[:, None]                     # (B, 1, S, rank + rope)
        y_lat = fa_ops.attend(q_mqa, k_mqa, k_mqa, causal=True, sm_scale=sm_scale)[..., :rank]

    # Un-absorb: y_h = y_lat W_uv_h, then the output projection.
    y = torch.matmul(y_lat, p["wv_up"].permute(1, 0, 2))                     # (B, H, S, vh)
    wo = p["wo"]
    return y.transpose(1, 2).reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
