"""Functional optimizers (AdamW, SGD with momentum) with moments stored in a
chosen dtype.

The port of the JAX package's ``optim/optimizers.py``. The state mirrors
the parameter tree: {"m": tree, "v": tree, "count": 0-d int32 tensor}
(SGD keeps no "v"). The math is the reference's, in float32: the bias
corrections ``1 - b ** count`` with count in float32, each moment
updated in float32 and stored in ``moment_dtype``, each parameter
updated in float32 and stored in its own dtype. Unlike the reference,
``opt_update`` writes the new parameters and moments into their own
storage under ``torch.no_grad()`` and returns the same trees: a
full-width model keeps one copy of its state on the card.

``opt_specs`` is the state's partition-spec tree: the moments shard as
the parameters do. On a mesh ``opt_update`` runs on each rank's local
shards, given the global gradient norm (``gnorm``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.ckpt.checkpoint import flatten
from repro_torch.dist.sharding import P


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" for the 405B recipe
    grad_clip: float = 1.0          # global-norm clip; 0 disables


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.9
    weight_decay: float = 0.0
    moment_dtype: str = "float32"
    grad_clip: float = 0.0


def _mdt(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moment_dtype]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (``rest``:
    trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves in the reference's flatten order (dict keys sorted)."""
    return [leaf for _, leaf in flatten(tree)]


def init_opt_state(params: Any, cfg) -> Any:
    dt = _mdt(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    count = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    if isinstance(cfg, AdamWConfig):
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "count": count}
    return {"m": tree_map(zeros, params), "count": count}


def opt_specs(param_specs: Any, cfg) -> Any:
    """The optimizer state's spec tree: moments shard exactly like the
    parameters, the count is replicated."""
    if isinstance(cfg, AdamWConfig):
        return {"m": param_specs, "v": param_specs, "count": P()}
    return {"m": param_specs, "count": P()}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over the leaves, in flatten order, of each leaf's
    float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def opt_update(grads: Any, state: Any, params: Any, cfg,
               lr: torch.Tensor, gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Any, Any, torch.Tensor]:
    """One step, in place. Returns (params, state, grad_norm): the trees
    given, updated. ``lr`` is a float32 0-d tensor (a schedule's value).
    ``gnorm``, when given, is the gradients' global norm (a caller whose
    trees are shards of the parameters passes the whole one's); else it is
    computed from ``grads``. Every other operation is elementwise."""
    flat_g = leaves(grads)
    if gnorm is None:
        gnorm = global_norm(flat_g)
    if cfg.grad_clip:
        scale = _clip_scale(gnorm, cfg.grad_clip)
        flat_g = [(g.float() * scale).to(g.dtype) for g in flat_g]
    state["count"].add_(1)
    dt = _mdt(cfg)
    flat_p, flat_m = leaves(params), leaves(state["m"])
    lr = torch.as_tensor(lr, dtype=torch.float32)

    if isinstance(cfg, AdamWConfig):
        b1, b2 = cfg.b1, cfg.b2
        c = state["count"].to(torch.float32)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=c.device)
        bc1 = 1.0 - torch.pow(f32(b1), c)
        bc2 = 1.0 - torch.pow(f32(b2), c)
        for p, g, m, v in zip(flat_p, flat_g, flat_m, leaves(state["v"])):
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if cfg.weight_decay:
                step = step + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            m.copy_(m32.to(dt))
            v.copy_(v32.to(dt))
        return params, state, gnorm

    for p, g, m in zip(flat_p, flat_g, flat_m):
        g32 = g.float()
        if cfg.weight_decay:
            g32 = g32 + cfg.weight_decay * p.float()
        m32 = cfg.momentum * m.float() + g32
        p.copy_(p.float() - lr * m32)
        m.copy_(m32.to(dt))
    return params, state, gnorm
