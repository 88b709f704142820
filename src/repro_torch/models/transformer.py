"""Decoder LM assembly: blocks, layer groups, KV and state caches, prefill
and decode.

The port of the JAX package's ``models/transformer.py`` for attention
blocks (kind ``"a"``: GQA, or MLA when ``cfg.use_mla``; the FFN a dense
SwiGLU, or with ``cfg.moe`` the mixture of experts of ``models/moe.py`` in
every "a" block, as the reference builds it: ``first_dense_layers`` enters
only the parameter count), Mamba2 blocks (kind ``"m"``) and the xLSTM's
mLSTM and sLSTM blocks (kinds ``"x"`` and ``"s"``; an mLSTM block's FFN
stays dense). ``cfg.block_cycle`` repeats to
cover ``num_layers`` as in the reference (``_groups``), but the layers of
a group are a list of per-repetition dicts run by an ordinary loop, not a
stack under ``lax.scan``: ``params["group_0"][r]["b0"]`` is layer r's block.
Caches mirror the same structure: {k, v} for an attention block ({ckv,
krope}, the latent, for an MLA block), {conv, ssm} for a Mamba2 block, the
(B, H, N, P + 1) matrix memory for an mLSTM block and {c, n, h} for an
sLSTM block, all updated in place. A config with the ``"audio"`` front end
gets the reference's identity ``frontend.proj`` leaf, which no forward pass
reads; ``"vision"`` changes nothing (chameleon's image codes are tokens).
An encoder-decoder config belongs to ``models/encdec.py``.
``repro_torch.convert.lm_params_from_reference`` unstacks a reference tree
into this layout. ``forward_loss`` (training) runs the blocks without
caches, each under ``torch.utils.checkpoint`` when ``cfg.remat ==
"full"``, and adds 0.01 times the MoE blocks' aux losses to the
cross-entropy, as the reference does; serving drops the aux.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.context import constrain_activations
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import specs as specs_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontend import frontend_kind
from repro_torch.models.layers import (
    cross_entropy_loss, dtype_of, embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm,
    unembed,
)

Params = Dict[str, Any]


def _check(cfg: ModelConfig) -> None:
    """Refuse an encoder-decoder config (``models/encdec.py`` builds it;
    ``zoo`` picks the module) and block kinds the reference has no block
    for."""
    if cfg.encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: use models.encdec "
                         "(zoo.model_module picks it)")
    kinds = set(cfg.block_cycle) - {"a", "m", "x", "s"}
    if kinds:
        raise ValueError(f"unknown block kinds {sorted(kinds)}")


def _groups(cfg: ModelConfig):
    cyc, n, rem = cfg.layer_cycles
    out = []
    if n:
        out.append((tuple(cyc), n))
    if rem:
        out.append((tuple(rem), 1))
    return out


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def init_block(gen, kind: str, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    if kind == "m":
        return {"ln": init_rmsnorm(d, dtype, device),
                "mixer": mamba_mod.init_mamba(gen, cfg, dtype, device)}
    if kind == "x":
        p = {"ln": init_rmsnorm(d, dtype, device),
             "mixer": xlstm_mod.init_mlstm(gen, cfg, dtype, device)}
        if cfg.d_ff:
            p["ln2"] = init_rmsnorm(d, dtype, device)
            p["ffn"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
        return p
    if kind == "s":
        return {"ln": init_rmsnorm(d, dtype, device),
                "mixer": xlstm_mod.init_slstm(gen, cfg, dtype, device)}
    return {
        "ln1": init_rmsnorm(d, dtype, device),
        "attn": (mla_mod.init_mla(gen, cfg, dtype, device) if cfg.use_mla
                 else attn_mod.init_attention(gen, cfg, dtype, device)),
        "ln2": init_rmsnorm(d, dtype, device),
        "ffn": (moe_mod.init_moe(gen, cfg, dtype, device) if cfg.moe
                else init_mlp(gen, d, cfg.d_ff, dtype, device)),
    }


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    if kind == "m":
        return mamba_mod.init_mamba_state(cfg, batch, dtype, device)
    if kind == "x":
        return xlstm_mod.init_mlstm_state(cfg, batch, device)
    if kind == "s":
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    if cfg.use_mla:
        return mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
    return attn_mod.init_cache(cfg, batch, max_len, dtype, device)


def apply_block(x, p: Params, kind: str, cfg: ModelConfig, positions, *, cache=None,
                cache_len=None, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux loss). Kind "a": pre-norm attention (MLA, always
    causal, when ``cfg.use_mla``), then the pre-norm SwiGLU or, with
    ``cfg.moe``, the mixture of experts, whose load-balancing loss is the
    aux (0 for every other block). Kinds "m", "x" and "s": the pre-norm
    Mamba2, mLSTM or sLSTM mixer (an mLSTM block with ``d_ff`` adds a
    pre-norm SwiGLU). With ``cache`` and no ``cache_len`` (prefill) a
    recurrent block writes its final state into the cache; with
    ``cache_len`` (decode) it steps the cached state, as the reference's
    modes do. Caches change in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("x", "s"):
        decode = cache_len is not None
        h = rmsnorm(x, p["ln"], cfg.norm_eps)
        mixer = xlstm_mod.mlstm_mixer if kind == "x" else xlstm_mod.slstm_mixer
        y, new_state = mixer(h, p["mixer"], cfg, state=cache if decode else None,
                             return_state=cache is not None and not decode)
        if kind == "x" and new_state is not None:
            cache.copy_(new_state)
        elif new_state is not None:
            for name, t in new_state.items():
                cache[name].copy_(t)
        x = x + y
        if kind == "x" and cfg.d_ff:
            x = x + mlp(rmsnorm(x, p["ln2"], cfg.norm_eps), p["ffn"])
        return x, aux
    if kind == "m":
        decode = cache_len is not None
        h = rmsnorm(x, p["ln"], cfg.norm_eps)
        y, new_state = mamba_mod.mamba_mixer(
            h, p["mixer"], cfg, state=cache if decode else None,
            return_state=cache is not None and not decode)
        if new_state is not None:
            cache["conv"].copy_(new_state["conv"])
            cache["ssm"].copy_(new_state["ssm"])
        return x + y, aux
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        x = x + mla_mod.mla_attention(h, p["attn"], cfg, positions, cache=cache,
                                      cache_len=cache_len)
    else:
        x = x + attn_mod.attention(h, p["attn"], cfg, positions, causal=causal,
                                   cache=cache, cache_len=cache_len)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe:
        y, aux = moe_mod.moe_ffn(h, p["ffn"], cfg)
        return x + y, aux
    return x + mlp(h, p["ffn"]), aux


# ---------------------------------------------------------------------------
# Parameters and caches
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's distribution (N(0, 1) times
    fan_in ** -0.5, the embedding table at scale 1.0, cast to cfg.dtype),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``.
    The bits are not JAX's; ``convert`` carries a reference tree over."""
    _check(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, dev,
                                cfg.tie_embeddings),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if frontend_kind(cfg) == "audio":
        # the reference's stub projection for precomputed frames: an identity
        # leaf that no forward pass reads (a "vision" front end adds none)
        p["frontend"] = {"proj": torch.eye(cfg.d_model, dtype=dtype, device=dev)}
    for gi, (pattern, n_rep) in enumerate(_groups(cfg)):
        p[f"group_{gi}"] = [{f"b{j}": init_block(gen, kind, cfg, dtype, dev)
                             for j, kind in enumerate(pattern)} for _ in range(n_rep)]
    return p


def param_specs(cfg: ModelConfig) -> Params:
    """The partition spec of every parameter leaf (``models.specs``), in the
    tree layout of ``init_params``."""
    p: Params = {"embed": specs_mod.embedding(cfg.tie_embeddings, cfg.fsdp),
                 "final_norm": specs_mod.rmsnorm()}
    if frontend_kind(cfg) == "audio":
        p["frontend"] = {"proj": specs_mod.P(None, "model")}
    for gi, (pattern, n_rep) in enumerate(_groups(cfg)):
        p[f"group_{gi}"] = [{f"b{j}": specs_mod.block(kind, cfg)
                             for j, kind in enumerate(pattern)} for _ in range(n_rep)]
    return p


def cache_specs(cfg: ModelConfig) -> Params:
    """The partition spec of every cache leaf, in the layout of
    ``init_caches``."""
    return {f"group_{gi}": [{f"b{j}": specs_mod.block_cache(kind, cfg)
                             for j, kind in enumerate(pattern)} for _ in range(n_rep)]
            for gi, (pattern, n_rep) in enumerate(_groups(cfg))}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Params:
    _check(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    return {f"group_{gi}": [{f"b{j}": init_block_cache(kind, cfg, batch, max_len, dtype, dev)
                             for j, kind in enumerate(pattern)} for _ in range(n_rep)]
            for gi, (pattern, n_rep) in enumerate(_groups(cfg))}


def _run_groups(params: Params, x, cfg: ModelConfig, positions, *,
                caches: Optional[Params] = None, cache_len=None,
                causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block in order; returns (x, the aux losses summed over the
    blocks). Serving passes ``caches`` (updated in place) and drops the
    aux, which is then not summed. Training passes none: with
    ``cfg.remat == "full"`` and gradients on, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant), so the backward pass keeps
    one block's activations at a time and runs each block's forward again,
    as the reference's per-block ``jax.checkpoint`` does."""
    remat = caches is None and cfg.remat == "full" and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (pattern, _) in enumerate(_groups(cfg)):
        for r, rep in enumerate(params[f"group_{gi}"]):
            x = constrain_activations(x)
            for j, kind in enumerate(pattern):
                cache = caches[f"group_{gi}"][r][f"b{j}"] if caches is not None else None
                run = functools.partial(apply_block, kind=kind, cfg=cfg, positions=positions,
                                        cache=cache, cache_len=cache_len, causal=causal)
                if remat:
                    x, aux = torch.utils.checkpoint.checkpoint(run, x, rep[f"b{j}"],
                                                               use_reentrant=False)
                else:
                    x, aux = run(x, rep[f"b{j}"])
                if caches is None:
                    aux_total = aux_total + aux
    return x, aux_total


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss (tokens (B, S) int64; labels < 0 masked) plus
    0.01 times the blocks' aux losses, as the reference's: a float32 0-d
    tensor to differentiate."""
    x = embed(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=x.device)
    x, aux = _run_groups(params, x, cfg, positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, params["embed"])
    return cross_entropy_loss(logits, labels) + 0.01 * aux


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, Params]:
    """Fill fresh caches with a prompt (B, S); returns (last-token logits
    (B, vocab) in cfg.dtype, caches)."""
    b, s = tokens.shape
    x = embed(tokens, params["embed"])
    positions = torch.arange(s, device=x.device)
    caches = init_caches(cfg, b, max_len, x.device)
    x, _ = _run_groups(params, x, cfg, positions, caches=caches)
    x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"])[:, 0], caches


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, caches: Params,
                token: torch.Tensor, cache_len: int) -> Tuple[torch.Tensor, Params]:
    """One serving step: token (B, 1) given ``cache_len`` cached tokens.
    The caches are updated in place and returned."""
    x = embed(token, params["embed"])
    positions = cache_len + torch.arange(1, device=x.device)
    x, _ = _run_groups(params, x, cfg, positions, caches=caches, cache_len=cache_len)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"])[:, 0], caches
