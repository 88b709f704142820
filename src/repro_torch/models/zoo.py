"""Uniform model facade over the decoder-only and encoder-decoder stacks:
the port of the JAX package's ``models/zoo.py``.

Batch convention (a dict of tensors):
  * decoder-only : {"tokens": (B, S) int64, "labels": (B, S) int64, -1 masked}
  * enc-dec      : {"frames": (B, S_src, d) float32 stub front-end
                    embeddings, "tokens": (B, S_tgt) int64, "labels":
                    (B, S_tgt) int64}

An encoder-decoder training batch of ``seq`` splits it as S_src = S_tgt =
seq // 2; a serving cell's source is ``CROSS_SRC_LEN`` frames (the cross
caches take the source's length, ``encdec.init_caches``).
chameleon (vision) is early-fusion: VQ image codes are ordinary
vocabulary ids, so its batch is the decoder-only form.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import P, batch_spec
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as transformer_mod
from repro_torch.models.config import ModelConfig

CROSS_SRC_LEN = 4096   # encoder memory length of an enc-dec decode cell


def model_module(cfg: ModelConfig):
    return encdec_mod if cfg.encdec else transformer_mod


def train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch from a ``torch.Generator`` seeded with ``seed`` (the
    reference's bits are JAX's), laid out as the reference's
    ``train_batch``: for a decoder-only model uniform tokens and their
    next-token labels, the last position masked with -1; for an
    encoder-decoder model N(0, 1) frames (batch, seq // 2, d_model) and
    seq // 2 uniform tokens, whose labels equal the tokens (the reference
    draws both from one key)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.encdec:
        s_src = s_tgt = max(seq // 2, 1)
        frames = torch.randn(batch, s_src, cfg.d_model, generator=gen, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (batch, s_tgt), generator=gen, device=dev)
        return {"frames": frames, "tokens": toks, "labels": toks.clone()}
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
    labels = torch.cat([toks[:, 1:], torch.full((batch, 1), -1, dtype=toks.dtype,
                                                device=dev)], dim=1)
    return {"tokens": toks, "labels": labels}


def loss_fn(cfg: ModelConfig) -> Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]:
    mod = model_module(cfg)
    if cfg.encdec:
        def f(params, batch):
            return mod.forward_loss(params, cfg, batch["frames"], batch["tokens"],
                                    batch["labels"])
        return f

    def f(params, batch):
        return mod.forward_loss(params, cfg, batch["tokens"], batch["labels"])
    return f


def prefill_fn(cfg: ModelConfig, max_len: int):
    mod = model_module(cfg)
    if cfg.encdec:
        def f(params, batch):
            return mod.prefill(params, cfg, batch["frames"], batch["tokens"], max_len)
        return f

    def f(params, batch):
        return mod.prefill(params, cfg, batch["tokens"], max_len)
    return f


def decode_fn(cfg: ModelConfig):
    mod = model_module(cfg)

    def f(params, caches, token, cache_len):
        return mod.decode_step(params, cfg, caches, token, cache_len)
    return f


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return model_module(cfg).init_params(cfg, seed, device)


def param_specs(cfg: ModelConfig):
    return model_module(cfg).param_specs(cfg)


def cache_specs(cfg: ModelConfig):
    return model_module(cfg).cache_specs(cfg)


def train_batch_specs(cfg: ModelConfig) -> Dict[str, P]:
    """A training batch's specs: batch-leading over ("pod", "data")."""
    if cfg.encdec:
        return {"frames": batch_spec(None, None), "tokens": batch_spec(None),
                "labels": batch_spec(None)}
    return {"tokens": batch_spec(None), "labels": batch_spec(None)}


# ---------------------------------------------------------------------------
# Reduced ("smoke") configs — same family, tiny dims, for CPU tests
# ---------------------------------------------------------------------------

def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Scale a config down to CPU-smoke size with the reference's rules
    (its ``reduce_config``): d 64, 2 layers for a dense model, two
    repetitions of the block cycle for a hybrid, MLA's latent ranks cut
    (q_lora_rank 32 when it has one, kv_lora_rank 16, qk_nope 16, qk_rope
    8, v_head 16), MoE cut to 4 routed experts of width 32 (top_k and the
    shared and dense-layer counts at most 2, 1 and 1), 4 SSD heads of state
    16 for an SSM family, and 2 + 2 encoder and decoder layers for an
    encoder-decoder model; ``overrides`` last."""
    small: Dict[str, Any] = dict(
        num_layers=max(2, min(4, len(cfg.block_cycle))),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads * 4 // max(cfg.num_heads, 1))),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        head_dim=16 if cfg.head_dim else 0,
        dtype="float32",
        remat="none",
        fsdp=False,
    )
    if cfg.use_mla:
        small.update(q_lora_rank=32 if cfg.q_lora_rank else 0,
                     kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                     v_head_dim=16)
    if cfg.moe:
        small.update(n_routed_experts=4, top_k=min(2, cfg.top_k),
                     moe_d_ff=32,
                     n_shared_experts=min(1, cfg.n_shared_experts),
                     first_dense_layers=min(1, cfg.first_dense_layers))
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_heads=4, ssm_head_dim=0)
    if cfg.encdec:
        small.update(enc_layers=2, dec_layers=2, num_layers=4)
    if len(cfg.block_cycle) > 1:
        small["num_layers"] = 2 * len(cfg.block_cycle)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
