"""Uniform model facade: the decoder-only part of the JAX package's
``models/zoo.py``.

Batch convention: {"tokens": (B, S) int64}. Encoder-decoder models (their
"frames" batches) are not ported yet (ROADMAP.md item 12).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models import transformer as transformer_mod
from repro_torch.models.config import ModelConfig


def model_module(cfg: ModelConfig):
    if cfg.encdec:
        raise NotImplementedError("encoder-decoder models are not ported yet "
                                  "(ROADMAP.md item 12)")
    return transformer_mod


def prefill_fn(cfg: ModelConfig, max_len: int):
    mod = model_module(cfg)

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


# ---------------------------------------------------------------------------
# Reduced ("smoke") configs — same family, tiny dims, for CPU tests
# ---------------------------------------------------------------------------

def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Scale a dense decoder-only config down to CPU-smoke size: the
    reference's ``reduce_config`` for that family (2 layers, d 64)."""
    return dataclasses.replace(
        cfg,
        num_layers=2,
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
