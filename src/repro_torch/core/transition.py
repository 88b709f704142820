"""Walk transition policies (paper Eq. 3 + §2.1/§2.2 baselines).

All policies expose one batched function:

    accept_prob(graph, prev, cur, cand, cand_edge_idx) -> (B,) float32

used inside the rejection loop of the walker engine (a rejected lane keeps
``cur`` and redraws next superstep). First-order policies also evaluate it
from one shard's partition-local CSR slice (``accept_prob_local``), which
the partition-local walk engine needs; node2vec reads N(prev), a row that
may live on another shard, so it runs only on the replicated engine.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph.csr import CSRGraph


def node_degrees(graph: CSRGraph, nodes: torch.Tensor) -> torch.Tensor:
    return (graph.indptr[nodes + 1] - graph.indptr[nodes]).to(torch.float32)


def row_contains(graph: CSRGraph, rows: torch.Tensor,
                 values: torch.Tensor, steps: int = 32) -> torch.Tensor:
    """Batched membership test: values[i] in sorted N(rows[i]).

    Fixed-step binary search over each CSR row: no data-dependent trip
    count, no host sync. 32 steps cover any |E| < 2^32; a caller that knows
    the longest row's length D may pass ``steps`` = D.bit_length(), since
    each step at least halves the interval."""
    last = graph.indices.shape[0] - 1
    lo = graph.indptr[rows]
    hi0 = graph.indptr[rows + 1]
    hi = hi0
    for _ in range(steps):
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
    # Whether accept_prob can be evaluated from one shard's slice alone.
    supports_partition_local: bool = False

    def accept_prob(self, graph, prev, cur, cand, cand_edge_idx) -> torch.Tensor:
        raise NotImplementedError

    def accept_prob_local(self, shards, prev, cur_local, cand, cand_edge_idx) -> torch.Tensor:
        """``accept_prob`` on the stacked partition-local slices
        (``graph.csr.ShardCSR``): every argument is (k, P), ``cur_local`` a
        local row and ``cand_edge_idx`` a local arc of the lane's shard.
        The same float32 expression, fed from the slices."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class HugePolicy(Policy):
    """HuGE information-oriented transition (Eq. 3):

        alpha(u,v) = 1/(deg(u) - Cm(u,v)) * max(deg(u)/deg(v), deg(v)/deg(u))
        P(u,v)     = Z(alpha * w(u,v)),  Z(x) = tanh(x)
    """

    needs_edge_cm = True
    supports_partition_local = True

    def accept_prob(self, graph, prev, cur, cand, cand_edge_idx):
        if graph.edge_cm is None:
            raise ValueError("HugePolicy requires graph.with_edge_cm()")
        w = None if graph.weights is None else graph.weights[cand_edge_idx]
        return _huge(node_degrees(graph, cur), node_degrees(graph, cand),
                     graph.edge_cm[cand_edge_idx], w)

    def accept_prob_local(self, shards, prev, cur_local, cand, cand_edge_idx):
        # deg(u) from the local row; deg(v), Cm and w from the arc-aligned halo.
        if shards.edge_cm is None:
            raise ValueError("HugePolicy requires graph.with_edge_cm()")
        deg_u = (shards.take("indptr", cur_local + 1)
                 - shards.take("indptr", cur_local)).to(torch.float32)
        w = None if shards.weights is None else shards.take("weights", cand_edge_idx)
        return _huge(deg_u, shards.take("nbr_deg", cand_edge_idx).to(torch.float32),
                     shards.take("edge_cm", cand_edge_idx), w)


def _huge(deg_u, deg_v, cm, w):
    """Eq. 3's acceptance from float32 degrees, Cm and the optional weight."""
    ratio = torch.maximum(deg_u / deg_v.clamp_min(1.0),
                          deg_v / deg_u.clamp_min(1.0))
    alpha = ratio / (deg_u - cm.to(torch.float32)).clamp_min(1.0)
    if w is not None:
        alpha = alpha * w
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

    supports_partition_local = True

    def accept_prob(self, graph, prev, cur, cand, cand_edge_idx):
        return torch.ones_like(cand, dtype=torch.float32)

    def accept_prob_local(self, shards, prev, cur_local, cand, cand_edge_idx):
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
