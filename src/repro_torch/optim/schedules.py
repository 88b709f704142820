"""Learning-rate schedules: pure functions of the step, in float32.

The port of the JAX package's ``optim/schedules.py``. Each schedule
returns a 0-d float32 tensor on the host, computed with the reference's
float32 operations in its order, so that an optimizer step on any device
multiplies by the same number.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def constant(lr: float):
    def f(step):
        return _f32(lr)
    return f


def linear_warmup(lr: float, warmup: int, total: int, end_frac: float = 0.0):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        frac = (s - warmup) / max(total - warmup, 1)
        decay = 1.0 - (1.0 - end_frac) * torch.clamp(frac, 0.0, 1.0)
        return _f32(lr) * torch.where(s < warmup, warm, decay)
    return f


def cosine_warmup(lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
        return _f32(lr) * torch.where(s < warmup, warm, cos)
    return f


def word2vec_linear(lr: float, min_lr: float, total: int):
    """The Skip-Gram convention: linear decay to min_lr over the corpus."""
    def f(step):
        frac = torch.clamp(_f32(step) / max(total, 1), 0.0, 1.0)
        return torch.maximum(_f32(lr) * (1 - frac), _f32(min_lr))
    return f
