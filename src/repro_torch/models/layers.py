"""Shared neural layers: RMSNorm, RoPE, SwiGLU, embeddings, the LM loss.

The port of the JAX package's ``models/layers.py``. Parameters are plain
nested dicts of tensors with the reference's names and layouts, so a
converted reference tree (``repro_torch.convert``) and the port's own
``init_*`` read the same. Types follow the reference: RMSNorm works in
float32 inside, RoPE rotates in float32, and each returns its input's
dtype; products of two tensors keep their dtype (on the card a bf16
product accumulates in float32 and rounds once, as XLA's does).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# -- initializers -------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, device, scale: float | None = None):
    """N(0, 1) * scale in float32, cast to ``dtype``; the scale defaults to
    fan_in ** -0.5 with fan_in = shape[0], as the reference's."""
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(*shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


# -- RMSNorm -------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].to(torch.float32)).to(dt)


# -- RoPE ------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, D even); positions: (S,). Rotates interleaved pairs
    (x[2i], x[2i+1]) by positions * freqs[i], in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                           # (D/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs       # (S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# -- SwiGLU MLP --------------------------------------------------------------------

def init_mlp(gen, d: int, d_ff: int, dtype, device) -> Params:
    return {
        "gate": dense_init(gen, (d, d_ff), dtype, device),
        "up": dense_init(gen, (d, d_ff), dtype, device),
        "down": dense_init(gen, (d_ff, d), dtype, device),
    }


def mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    g = torch.nn.functional.silu(x @ p["gate"])
    u = x @ p["up"]
    return (g * u) @ p["down"]


# -- Embeddings ------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int, dtype, device, tie: bool) -> Params:
    p = {"table": dense_init(gen, (vocab, d), dtype, device, scale=1.0)}
    if not tie:
        p["head"] = dense_init(gen, (d, vocab), dtype, device)
    return p


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    return p["table"][tokens]


def unembed(x: torch.Tensor, p: Params) -> torch.Tensor:
    if "head" in p:
        return x @ p["head"]
    return x @ p["table"].T


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in float32; labels < 0 are masked. Written as
    logsumexp minus the picked logit, as the reference writes it."""
    mask = labels >= 0
    safe = torch.clamp_min(labels, 0)
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, lse - picked, 0.0)
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1)
