"""Encoder-decoder LM (the seamless-m4t backbone): the port of the JAX
package's ``models/encdec.py``.

Encoder: bidirectional attention blocks over precomputed frame embeddings
(the audio front end is a stub, ``models/frontend.py``: (B, S_src,
d_model) float32 frames, cast to ``cfg.dtype``), RoPE over
``arange(S_src)``. Decoder: causal self-attention, cross-attention to the
encoder's output (no RoPE) and a SwiGLU MLP, each pre-norm.

Layout: the reference stacks each stack's layers on a leading axis under
``lax.scan``; the port keeps a list with one dict per layer
(``params["enc"][i]``, ``params["dec"][i]``), run by an ordinary loop, as
the decoder-only stack's ``group_<i>`` lists are
(``convert.lm_params_from_reference`` unstacks a reference tree). The
serving caches are a list with one {"self": {k, v}, "cross": {k, v}} per
decoder layer, updated in place: a prefill fills both, a decode step
appends to "self" and only reads "cross".

On the card every attention of a prefill or a training forward is K2
(``kernels.flash_attention.ops.attend``): the encoder's self-attention
non-causal over S_src keys, the decoder's causal, and the cross-attention
non-causal with Sq the target length and Skv = S_src (``_cross_fresh``,
where the reference calls its plain ``mha_reference`` / ``mha_chunked``;
K2 computes the same function). A decode step attends with plain ops, as
the reference's does outside any kernel. Training runs each block under
``torch.utils.checkpoint`` when ``cfg.remat == "full"``, as the reference
wraps each scanned block in ``jax.checkpoint``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.context import constrain_activations
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import specs as specs_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    cross_entropy_loss, dtype_of, embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm,
    unembed,
)

Params = Dict[str, Any]


def _enc_block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device),
        "attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _dec_block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device),
        "self_attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "ln_x": init_rmsnorm(cfg.d_model, dtype, device),
        "cross_attn": attn_mod.init_attention(gen, cfg, dtype, device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's distribution, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (not JAX's bits;
    ``convert`` carries a reference tree over). Both stacks need a layer:
    the reference's stacking of zero layers raises too."""
    if cfg.enc_layers < 1 or cfg.dec_layers < 1:
        raise ValueError(f"{cfg.name}: an encoder-decoder model needs enc_layers and "
                         f"dec_layers >= 1, got {cfg.enc_layers} and {cfg.dec_layers}")
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, dev,
                                cfg.tie_embeddings),
        "enc": [_enc_block_init(gen, cfg, dtype, dev) for _ in range(cfg.enc_layers)],
        "enc_norm": init_rmsnorm(cfg.d_model, dtype, dev),
        "dec": [_dec_block_init(gen, cfg, dtype, dev) for _ in range(cfg.dec_layers)],
        "final_norm": init_rmsnorm(cfg.d_model, dtype, dev),
    }


def param_specs(cfg: ModelConfig) -> Params:
    """The partition spec of every parameter leaf (``models.specs``), in the
    tree layout of ``init_params``."""
    return {"embed": specs_mod.embedding(cfg.tie_embeddings, cfg.fsdp),
            "enc": [specs_mod.enc_block(cfg) for _ in range(cfg.enc_layers)],
            "enc_norm": specs_mod.rmsnorm(),
            "dec": [specs_mod.dec_block(cfg) for _ in range(cfg.dec_layers)],
            "final_norm": specs_mod.rmsnorm()}


def cache_specs(cfg: ModelConfig) -> List[Params]:
    """The partition spec of every cache leaf, in the layout of
    ``init_caches``."""
    return [{"self": specs_mod.kv_cache(cfg), "cross": specs_mod.kv_cache(cfg)}
            for _ in range(cfg.dec_layers)]


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat == "full" and torch.is_grad_enabled()


def _run(block, x, p, remat: bool):
    if remat:
        return torch.utils.checkpoint.checkpoint(block, x, p, use_reentrant=False)
    return block(x, p)


def _enc_block(x, p: Params, cfg: ModelConfig, positions) -> torch.Tensor:
    x = constrain_activations(x)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn_mod.attention(h, p["attn"], cfg, positions, causal=False)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(h, p["ffn"])


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_src, d_model) front-end embeddings -> (B, S_src,
    d_model) in cfg.dtype."""
    x = frames.to(dtype_of(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    block = functools.partial(_enc_block, cfg=cfg, positions=positions)
    for p in params["enc"]:
        x = _run(block, x, p, _remat(cfg))
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _cross_fresh(h, p: Params, cfg: ModelConfig, enc_out, cache: Optional[Params]):
    """Cross-attention with K/V from the encoder's output (K2, non-causal,
    Sq = the target length, Skv = S_src); with ``cache`` (prefill) the K/V
    are written into it."""
    q = attn_mod.heads(h, p["wq"])
    k = attn_mod.heads(enc_out, p["wk"])
    v = attn_mod.heads(enc_out, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cache is not None:
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    return attn_mod.merge_heads(fa_ops.attend(q, k, v, causal=False), p["wo"])


def _cross_from_cache(h, p: Params, cfg: ModelConfig, cache: Params) -> torch.Tensor:
    """Cross-attention against the cached encoder K/V, which it only reads:
    a plain softmax over every source position, as the reference's."""
    q = attn_mod.heads(h, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return attn_mod.merge_heads(attn_mod.attend_cache(q, cache["k"], cache["v"]), p["wo"])


def _dec_block(x, p: Params, cfg: ModelConfig, positions, enc_out, cache, cache_len,
               mode: str) -> torch.Tensor:
    x = constrain_activations(x)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn_mod.attention(h, p["self_attn"], cfg, positions, causal=True,
                               cache=None if cache is None else cache["self"],
                               cache_len=cache_len)
    h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
    if mode == "decode":
        x = x + _cross_from_cache(h, p["cross_attn"], cfg, cache["cross"])
    else:
        x = x + _cross_fresh(h, p["cross_attn"], cfg, enc_out,
                             None if cache is None else cache["cross"])
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(h, p["ffn"])


def _decoder(params: Params, cfg: ModelConfig, x, enc_out, positions,
             caches: Optional[List[Params]] = None, cache_len: Optional[int] = None,
             mode: str = "train") -> torch.Tensor:
    """The decoder's blocks in order. ``mode``: "train" (no caches; each
    block under ``torch.utils.checkpoint`` with ``cfg.remat == "full"``
    and gradients on), "prefill" (fills ``caches``) or "decode" (appends
    to each layer's self cache at ``cache_len``; reads the cross cache)."""
    remat = mode == "train" and _remat(cfg)
    for i, p in enumerate(params["dec"]):
        block = functools.partial(_dec_block, cfg=cfg, positions=positions, enc_out=enc_out,
                                  cache=None if caches is None else caches[i],
                                  cache_len=cache_len, mode=mode)
        x = _run(block, x, p, remat)
    return x


def forward_loss(params: Params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Mean token loss of the decoder over ``tokens`` (B, S_tgt) int64
    given ``frames`` (B, S_src, d_model); labels < 0 masked. A float32 0-d
    tensor to differentiate."""
    enc_out = encode(params, cfg, frames)
    x = embed(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=x.device)
    x = _decoder(params, cfg, x, enc_out, positions, mode="train")
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return cross_entropy_loss(unembed(x, params["embed"]), labels)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, src_len: int,
                device="cuda") -> List[Params]:
    """Per decoder layer: the self K/V cache over ``max_len`` positions and
    the cross K/V over ``src_len`` source positions, zeros in cfg.dtype."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    return [{"self": attn_mod.init_cache(cfg, batch, max_len, dtype, dev),
             "cross": attn_mod.init_cache(cfg, batch, src_len, dtype, dev)}
            for _ in range(cfg.dec_layers)]


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, List[Params]]:
    """Encode the source and run the prompt (B, S) through the decoder,
    filling fresh caches; returns (last-token logits (B, vocab) in
    cfg.dtype, caches)."""
    b, s = tokens.shape
    enc_out = encode(params, cfg, frames)
    caches = init_caches(cfg, b, max_len, frames.shape[1], enc_out.device)
    x = embed(tokens, params["embed"])
    positions = torch.arange(s, device=x.device)
    x = _decoder(params, cfg, x, enc_out, positions, caches=caches, mode="prefill")
    x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"])[:, 0], caches


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, caches: List[Params], token: torch.Tensor,
                cache_len: int) -> Tuple[torch.Tensor, List[Params]]:
    """One serving step: token (B, 1) given ``cache_len`` cached target
    tokens. The self caches are updated in place and returned."""
    x = embed(token, params["embed"])
    positions = cache_len + torch.arange(1, device=x.device)
    x = _decoder(params, cfg, x, None, positions, caches=caches, cache_len=cache_len,
                 mode="decode")
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"])[:, 0], caches
