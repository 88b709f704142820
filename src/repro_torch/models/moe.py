"""Mixture of experts: shared + routed experts, a top-k softmax router and
capacity-based dispatch.

The port of the JAX package's ``models/moe.py``, step for step. The router
runs in float32 on the tokens; its top-k picks come from a stable
descending sort, which breaks ties toward the lowest expert index as
``jax.lax.top_k`` does (``torch.topk`` does not). Each (token, slot) pair
takes its position in its expert from a cumulative sum over the
token-major order, per dispatch group; pairs at or past the expert's
capacity round(T_g · k / E · capacity_factor) (Python's ``round``, half
to even) are dropped and add nothing. The kept pairs fill an (E_p · C, d)
buffer per group, the SwiGLU experts run batched over the E_p expert
slots (E padded to a multiple of ``PRODUCTION_MODEL_AXIS``; the router
only ever picks the first E), and each kept pair comes back weighted by
its gate, the gates cast to the activations' dtype first. One shared-
expert MLP of width ``n_shared_experts · moe_d_ff`` runs on every token
and is added after. The expert products are plain batched matrix
products, as the reference leaves them to XLA: MoE has no Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, mlp

Params = Dict[str, Any]

# The production mesh's tensor axis (the JAX package's
# ``dist/sharding.py``): expert slots are padded to a multiple of it.
PRODUCTION_MODEL_AXIS = 16


def padded_experts(cfg: ModelConfig) -> int:
    """The expert count padded to ``PRODUCTION_MODEL_AXIS``: qwen2-moe's 60
    routed experts take 64 parameter slots; the pad slots get no token."""
    m = PRODUCTION_MODEL_AXIS
    return -(-cfg.n_routed_experts // m) * m


def init_moe(gen, cfg: ModelConfig, dtype, device) -> Params:
    """The router (d, E) in float32 over the real experts; gate and up
    (E_p, d, f) and down (E_p, f, d) in ``dtype``, drawn with fan_in =
    shape[0] (E_p for the expert tensors, as the reference draws them);
    the shared MLP when ``n_shared_experts``."""
    d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
    ep = padded_experts(cfg)
    p: Params = {
        "router": dense_init(gen, (d, e), torch.float32, device),
        "gate": dense_init(gen, (ep, d, f), dtype, device),
        "up": dense_init(gen, (ep, d, f), dtype, device),
        "down": dense_init(gen, (ep, f, d), dtype, device),
    }
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * f
        p["shared"] = {
            "gate": dense_init(gen, (d, sf), dtype, device),
            "up": dense_init(gen, (d, sf), dtype, device),
            "down": dense_init(gen, (sf, d), dtype, device),
        }
    return p


class Routing(NamedTuple):
    gate_w: torch.Tensor      # (T, k) float32, renormalised over the k picks
    gate_e: torch.Tensor      # (T, k) int64, the experts picked, best first
    keep: torch.Tensor        # (G, T_g * k) bool: the pair fits its expert's capacity
    slot: torch.Tensor        # (G, T_g * k) int64: expert * C + position (0 when dropped)
    capacity: int
    aux: torch.Tensor         # () float32, the Switch load-balancing loss


def pick(xt: torch.Tensor, p: Params,
         cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on tokens xt (T, d): (gate_w (T, k) float32, renormalised
    over the k picks; gate_e (T, k) int64, the experts picked, best first;
    probs (T, E) float32)."""
    k = cfg.top_k
    logits = xt.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)                                  # (T, E)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = top_w[:, :k], top_e[:, :k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return gate_w, gate_e, probs


def plan(gate_w: torch.Tensor, gate_e: torch.Tensor, probs: torch.Tensor,
         cfg: ModelConfig) -> Routing:
    """The dispatch plan and the aux loss for the router's picks."""
    t, k = gate_e.shape
    e = cfg.n_routed_experts
    groups = max(cfg.moe_dispatch_groups, 1)
    if t % groups != 0:
        groups = 1
    t_g = t // groups
    capacity = int(max(1, round(t_g * k / e * cfg.capacity_factor)))

    # Position of each (token, slot) in its expert: a cumulative sum over
    # the token-major order, per group, run along the innermost axis of an
    # expert-major one-hot (on the card a scan down a middle axis took 13
    # ms a layer at a 4 x 1,819 prefill).
    flat_e = gate_e.reshape(groups, t_g * k)
    experts = torch.arange(e, device=flat_e.device)
    onehot = flat_e[:, None, :] == experts[None, :, None]                  # (G, E, T_g k)
    pos = (onehot.cumsum(dim=2) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity
    slot = flat_e * capacity + torch.where(keep, pos, 0)

    # Load-balancing aux loss (Switch): E * sum_e f_e * p_e, the counts
    # f_e taken from the one-hot (no read-back to the host).
    me = probs.mean(dim=0)
    ce = onehot.sum((0, 2)).to(torch.float32) / (t * k)
    aux = e * torch.sum(me * ce)
    return Routing(gate_w, gate_e, keep, slot, capacity, aux)


def moe_ffn(x: torch.Tensor, p: Params, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, the aux loss)."""
    b, s, d = x.shape
    k = cfg.top_k
    ep = padded_experts(cfg)
    t = b * s
    xt = x.reshape(t, d)
    r = plan(*pick(xt, p, cfg), cfg)
    groups, n_pairs = r.keep.shape
    cap = r.capacity

    # Dispatch: each kept pair into its row of the group's (E_p * C, d)
    # buffer; every dropped pair into one spare row past the end (the
    # reference adds it as zeros at its expert's position 0).
    src = xt.reshape(groups, n_pairs // k, d).repeat_interleave(k, dim=1)      # (G, T_g k, d)
    rows = torch.where(r.keep, r.slot, ep * cap)
    buf = torch.zeros(groups, ep * cap + 1, d, dtype=xt.dtype, device=xt.device)
    buf.scatter_(1, rows[..., None].expand(-1, -1, d), src)
    buf = buf[:, :ep * cap].reshape(groups, ep, cap, d)

    # The SwiGLU experts, batched over the expert slots.
    g = torch.nn.functional.silu(torch.einsum("gecd,edf->gecf", buf, p["gate"]))
    u = torch.einsum("gecd,edf->gecf", buf, p["up"])
    out = torch.einsum("gecf,efd->gecd", g * u, p["down"]).reshape(groups, ep * cap, d)

    # Combine: each pair's row back, times its gate (zero when dropped), in
    # the activations' dtype, summed over the k picks.
    gate = torch.where(r.keep, r.gate_w.reshape(groups, n_pairs), 0.0).to(xt.dtype)
    back = out.gather(1, r.slot[..., None].expand(-1, -1, d)) * gate[..., None]
    y = back.reshape(t, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        y = y + mlp(xt, p["shared"])
    return y.reshape(b, s, d).to(x.dtype), r.aux
