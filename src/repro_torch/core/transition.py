"""Walk transition policies (paper Eq. 3 + §2.1/§2.2 baselines).

All policies expose one batched function:

    accept_prob(graph, prev, cur, cand, cand_edge_idx) -> (B,) float32

used inside the rejection loop of the walker engine (a rejected lane keeps
``cur`` and redraws next superstep).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph.csr import CSRGraph


def node_degrees(graph: CSRGraph, nodes: torch.Tensor) -> torch.Tensor:
    return (graph.indptr[nodes + 1] - graph.indptr[nodes]).to(torch.float32)


def row_contains(graph: CSRGraph, rows: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """Batched membership test: values[i] in sorted N(rows[i]).

    Fixed 32-step binary search over each CSR row (covers any |E| < 2^32):
    no data-dependent trip count, no host sync."""
    last = graph.indices.shape[0] - 1
    lo = graph.indptr[rows]
    hi0 = graph.indptr[rows + 1]
    hi = hi0
    for _ in range(32):
        searching = lo < hi
        mid = (lo + hi) // 2
        less = graph.indices[mid.clamp(0, last)] < values
        lo = torch.where(searching & less, mid + 1, lo)
        hi = torch.where(searching & ~less, mid, hi)
    pos = lo.clamp(0, last)
    return (lo < hi0) & (graph.indices[pos] == values)


class Policy:
    """Base class — subclasses are stateless, graph-closed callables."""

    needs_edge_cm: bool = False     # HuGE transition needs Cm(u,v) precompute

    def accept_prob(self, graph, prev, cur, cand, cand_edge_idx) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class HugePolicy(Policy):
    """HuGE information-oriented transition (Eq. 3):

        alpha(u,v) = 1/(deg(u) - Cm(u,v)) * max(deg(u)/deg(v), deg(v)/deg(u))
        P(u,v)     = Z(alpha * w(u,v)),  Z(x) = tanh(x)
    """

    needs_edge_cm = True

    def accept_prob(self, graph, prev, cur, cand, cand_edge_idx):
        deg_u = node_degrees(graph, cur)
        deg_v = node_degrees(graph, cand)
        if graph.edge_cm is None:
            raise ValueError("HugePolicy requires graph.with_edge_cm()")
        cm = graph.edge_cm[cand_edge_idx].to(torch.float32)
        ratio = torch.maximum(deg_u / deg_v.clamp_min(1.0),
                              deg_v / deg_u.clamp_min(1.0))
        alpha = ratio / (deg_u - cm).clamp_min(1.0)
        if graph.weights is not None:
            alpha = alpha * graph.weights[cand_edge_idx]
        return torch.tanh(alpha)


@dataclasses.dataclass(frozen=True)
class Node2vecPolicy(Policy):
    """node2vec second-order walk via rejection sampling (KnightKing §2.2).

    pi(u,v) = 1/p if v == prev; 1 if v in N(prev); 1/q otherwise.
    Envelope Q = max(1/p, 1, 1/q); acceptance = pi / Q.
    """

    p: float = 1.0
    q: float = 1.0

    def accept_prob(self, graph, prev, cur, cand, cand_edge_idx):
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=cand.device)
        inv_p, inv_q = f32(1.0 / self.p), f32(1.0 / self.q)
        envelope = torch.maximum(torch.maximum(inv_p, f32(1.0)), inv_q)
        is_common = row_contains(graph, prev, cand)
        pi = torch.where(cand == prev, inv_p, torch.where(is_common, f32(1.0), inv_q))
        # First step of a walk has prev == cur: uniform first hop.
        pi = torch.where(prev == cur, envelope, pi)
        return pi / envelope


@dataclasses.dataclass(frozen=True)
class DeepwalkPolicy(Policy):
    """Uniform first-order walk — every candidate accepted."""

    def accept_prob(self, graph, prev, cur, cand, cand_edge_idx):
        return torch.ones_like(cand, dtype=torch.float32)


def make_policy(name: str, **kwargs) -> Policy:
    name = name.lower()
    if name == "huge":
        return HugePolicy()
    if name == "node2vec":
        return Node2vecPolicy(p=kwargs.get("p", 1.0), q=kwargs.get("q", 1.0))
    if name == "deepwalk":
        return DeepwalkPolicy()
    raise ValueError(f"unknown policy {name!r}")
