"""MPGP — multi-proximity-aware streaming parallel graph partitioning (§3.2).

An un-partitioned node v is assigned to

    argmax_i ( PS1(v, P_i) + PS2(v, P_i) ) * tau(P_i)          (Eq. 14)
    tau(P_i) = 1 - |P_i| / (gamma * (sum_j |P_j|) / m)          (Eq. 15)

PS1 = |N(v) ∩ P_i|  (first-order proximity: neighbours already in P_i)
PS2 = Σ_{u ∈ P_i ∩ N(v)} |N(v) ∩ N(u)|  (second-order: common neighbours,
      restricted to u that are themselves neighbours of v).

Weighted graphs multiply each term by w(v, u). Streaming orders: random,
natural, bfs, dfs, bfs+degree, dfs+degree (the '+degree' orders visit the
highest-degree unexplored neighbour first). Parallel MPGP partitions
segments of the stream independently and merges them.

The partition is host preprocessing, as in the reference, and its
assignment is bit-identical to ``repro.core.mpgp``'s. Two things make the
stream loop cheaper than the reference's:

- |N(v) ∩ N(u)| of an arc (v, u) is the graph's per-arc common-neighbour
  count ``edge_cm`` (computed once on the graph's device, and needed by
  HuGE's walks anyway), not one galloping intersection per placed
  neighbour: the same integer, since both scan the shorter row (v's on a
  tie) and search each entry in the longer one;
- the loop runs over Python lists, not one small numpy call per node. On
  unweighted graphs the scores are sums of integers, exact in any order;
  on weighted graphs the additions keep the reference's order (PS1 over
  the placed neighbours, then PS2 over them), and every float operation
  is the reference's float64 operation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.stats import edge_locality, partition_balance


@dataclasses.dataclass
class PartitionResult:
    assignment: np.ndarray       # (|V|,) int32 partition id per node
    num_parts: int
    gamma: float
    order: str
    seconds: float
    locality: float              # fraction of arcs kept intra-partition
    balance: float               # max/mean partition size

    def counts(self) -> np.ndarray:
        return np.bincount(self.assignment, minlength=self.num_parts)


@dataclasses.dataclass(frozen=True)
class HostCSR:
    """The graph's arrays on the host, as the stream loop reads them."""

    indptr: np.ndarray               # (|V|+1,) int64
    indices: np.ndarray              # (|E|,) int64
    weights: Optional[np.ndarray]    # (|E|,) float32 or None
    edge_cm: Optional[np.ndarray]    # (|E|,) int64 or None

    @classmethod
    def of(cls, graph: CSRGraph, with_cm: bool) -> "HostCSR":
        if with_cm:
            graph = graph.with_edge_cm()
        host = lambda t: None if t is None else t.cpu().numpy()
        cm = host(graph.edge_cm) if with_cm else None
        return cls(indptr=host(graph.indptr).astype(np.int64),
                   indices=host(graph.indices).astype(np.int64),
                   weights=host(graph.weights),
                   edge_cm=None if cm is None else cm.astype(np.int64))

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1


def _intersect_count_sorted(a: np.ndarray, b: np.ndarray) -> int:
    """|a ∩ b| for sorted int arrays by binary search of the smaller set in
    the larger (the reference's galloping count; ``edge_cm`` gives the same
    number per arc)."""
    if a.size > b.size:
        a, b = b, a
    if a.size == 0 or b.size == 0:
        return 0
    pos = np.searchsorted(b, a)
    pos = np.minimum(pos, b.size - 1)
    return int(np.sum(b[pos] == a))


def _rows_sorted_by_degree(indptr: np.ndarray, indices: np.ndarray, deg: np.ndarray,
                           descending: bool) -> np.ndarray:
    """Each row's neighbours in a stable order of their degree: per row what
    ``nbrs[np.argsort(±deg[nbrs], kind="stable")]`` gives, for all rows in
    one sort."""
    n = len(indptr) - 1
    top = int(deg.max()) if n else 0
    row = np.repeat(np.arange(n, dtype=np.int64), indptr[1:] - indptr[:-1])
    d = deg[indices]
    key = row * (top + 1) + ((top - d) if descending else d)
    return indices[np.argsort(key, kind="stable")]


def stream_order(graph: CSRGraph, order: str, seed: int = 0) -> np.ndarray:
    """Node visit order for the stream. BFS/DFS run over all components,
    seeded from the highest-degree roots; '+degree' variants visit the
    highest-degree unexplored neighbour first."""
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    indices = graph.indices.cpu().numpy().astype(np.int64)
    n = len(indptr) - 1
    order = order.lower()
    if order == "random":
        return np.random.default_rng(seed).permutation(n).astype(np.int64)
    if order == "natural":
        return np.arange(n, dtype=np.int64)

    by_degree = order.endswith("+degree") or order.endswith("+deg")
    kind = order.split("+")[0]
    if kind not in ("bfs", "dfs"):
        raise ValueError(f"unknown stream order {order!r}")

    deg = indptr[1:] - indptr[:-1]
    if by_degree:
        # BFS enqueues the highest degree first; DFS pushes the lowest first,
        # so that the highest pops first.
        indices = _rows_sorted_by_degree(indptr, indices, deg, descending=kind == "bfs")
    nbr: List[int] = indices.tolist()
    ptr: List[int] = indptr.tolist()
    visited = bytearray(n)
    out: List[int] = []
    for root in np.argsort(-deg, kind="stable").tolist():
        if visited[root]:
            continue
        visited[root] = 1
        if kind == "bfs":
            queue = [root]
            head = 0
            while head < len(queue):
                u = queue[head]
                head += 1
                for v in nbr[ptr[u]:ptr[u + 1]]:
                    if not visited[v]:
                        visited[v] = 1
                        queue.append(v)
            out.extend(queue)
        else:
            stack = [root]
            while stack:
                u = stack.pop()
                out.append(u)
                for v in nbr[ptr[u]:ptr[u + 1]]:
                    if not visited[v]:
                        visited[v] = 1
                        stack.append(v)
    assert len(out) == n
    return np.asarray(out, dtype=np.int64)


def _assign_stream(
    g: HostCSR,
    nodes: np.ndarray,
    assignment: np.ndarray,
    counts: np.ndarray,
    num_parts: int,
    gamma: float,
    use_ps2: bool = True,
    tau_weight: str = "nodes",
    allowed: Optional[np.ndarray] = None,
) -> None:
    """Assign ``nodes`` (in order) in place into ``assignment``/``counts``.

    ``assignment`` may already hold other nodes' parts; -1 marks
    unassigned. ``allowed`` (bool (num_parts,)) restricts the argmax to a
    subset of parts. ``tau_weight`` is the load a node adds to Eq. 15's
    capacity term: ``"nodes"`` (1, the paper's) or ``"degree"``
    (deg(v) + 1). PS2 reads ``g.edge_cm`` (required when ``use_ps2``)."""
    if tau_weight not in ("nodes", "degree"):
        raise ValueError(f"unknown tau_weight {tau_weight!r}")
    if use_ps2 and g.edge_cm is None:
        raise ValueError("PS2 needs the graph's edge_cm")
    degree_tau = tau_weight == "degree"
    ptr: List[int] = g.indptr.tolist()
    nbr: List[int] = g.indices.tolist()
    asg: List[int] = assignment.tolist()
    cnt: List[int] = [int(c) for c in counts]
    ok = None if allowed is None else [bool(a) for a in allowed]
    weighted = g.weights is not None
    if weighted:
        wts: List[float] = g.weights.astype(np.float64).tolist()
        cms: List[int] = g.edge_cm.tolist() if use_ps2 else []
    else:
        # Unweighted: an arc adds 1 (PS1) plus its common-neighbour count.
        gain: List[int] = (g.edge_cm + 1).tolist() if use_ps2 else [1] * len(nbr)
    parts = range(num_parts)
    minus_inf = float("-inf")

    for v in nodes.tolist():
        lo, hi = ptr[v], ptr[v + 1]
        scores = [0.0] * num_parts
        if weighted:
            placed = [e for e in range(lo, hi) if asg[nbr[e]] >= 0]
            for e in placed:                  # PS1, in the reference's order
                scores[asg[nbr[e]]] += wts[e]
            if use_ps2:
                for e in placed:              # then PS2
                    scores[asg[nbr[e]]] += cms[e] * wts[e]
        else:
            acc = [0] * num_parts
            for e in range(lo, hi):
                p = asg[nbr[e]]
                if p >= 0:
                    acc[p] += gain[e]
            scores = [float(a) for a in acc]
        total = sum(cnt)
        if total > 0:
            cap = gamma * total / num_parts
            tau = [1.0 - c / cap for c in cnt]
        else:
            tau = [1.0] * num_parts
        # Nodes with no placed neighbours score 0 everywhere: tau breaks the
        # tie toward the least-loaded part.
        if any(s != 0.0 for s in scores):
            obj = [s * t for s, t in zip(scores, tau)]
        else:
            obj = tau
        if ok is not None:
            obj = [o if a else minus_inf for o, a in zip(obj, ok)]
        best = 0
        for i in parts:                       # the first maximum, as np.argmax
            if obj[i] > obj[best]:
                best = i
        asg[v] = best
        cnt[best] += (hi - lo + 1) if degree_tau else 1
    assignment[:] = asg
    counts[:] = cnt


def _result(graph, assignment, num_parts, gamma, order, t0) -> PartitionResult:
    return PartitionResult(
        assignment=assignment, num_parts=num_parts, gamma=gamma, order=order,
        seconds=time.perf_counter() - t0,
        locality=edge_locality(graph, assignment),
        balance=partition_balance(assignment, num_parts))


def mpgp_partition(
    graph: CSRGraph,
    num_parts: int,
    *,
    gamma: float = 2.0,
    order: str = "dfs+degree",
    use_ps2: bool = True,
    seed: int = 0,
    tau_weight: str = "nodes",
) -> PartitionResult:
    """Sequential MPGP (the paper's recommended order: DFS+degree).
    ``seconds`` covers the stream order and the stream, and ``edge_cm``
    when the graph did not have it yet."""
    t0 = time.perf_counter()
    g = HostCSR.of(graph, with_cm=use_ps2)
    nodes = stream_order(graph, order, seed)
    assignment = np.full(g.num_nodes, -1, dtype=np.int32)
    counts = np.zeros(num_parts, dtype=np.int64)
    _assign_stream(g, nodes, assignment, counts, num_parts, gamma, use_ps2, tau_weight)
    label = order if tau_weight == "nodes" else f"{order}:tau={tau_weight}"
    return _result(graph, assignment, num_parts, gamma, label, t0)


def mpgp_partition_parallel(
    graph: CSRGraph,
    num_parts: int,
    *,
    gamma: float = 2.0,
    order: str = "bfs+degree",
    num_segments: int = 4,
    use_ps2: bool = True,
    seed: int = 0,
    tau_weight: str = "nodes",
) -> PartitionResult:
    """Parallel MPGP (the paper's fourth optimization): the stream is cut
    into ``num_segments`` segments, each partitioned as if alone, and the
    results merged (the segments hold disjoint nodes). They run one after
    another here; each keeps its own state, as parallel workers would."""
    t0 = time.perf_counter()
    g = HostCSR.of(graph, with_cm=use_ps2)
    n = g.num_nodes
    nodes = stream_order(graph, order, seed)
    bounds = np.linspace(0, n, num_segments + 1).astype(np.int64)
    assignment = np.full(n, -1, dtype=np.int32)
    for s in range(num_segments):
        seg_nodes = nodes[bounds[s]:bounds[s + 1]]
        seg_assign = np.full(n, -1, dtype=np.int32)
        seg_counts = np.zeros(num_parts, dtype=np.int64)
        _assign_stream(g, seg_nodes, seg_assign, seg_counts, num_parts, gamma, use_ps2,
                       tau_weight)
        assignment[seg_nodes] = seg_assign[seg_nodes]
    return _result(graph, assignment, num_parts, gamma,
                   f"parallel:{order}x{num_segments}", t0)


def balanced_only_partition(graph: CSRGraph, num_parts: int, *,
                            seed: int = 0) -> PartitionResult:
    """KnightKing-style workload-balancing-only partition (§2.2): nodes,
    heaviest degree first, each onto the least-loaded part (the first on a
    tie), ignoring locality: the baseline MPGP beats in Fig. 10(c,d)."""
    t0 = time.perf_counter()
    deg = graph.degrees().cpu().numpy().astype(np.int64)
    n = graph.num_nodes
    load = [0] * num_parts
    out = [0] * n
    parts = range(num_parts)
    order = np.argsort(-deg, kind="stable")
    for v, d in zip(order.tolist(), deg[order].tolist()):
        p = 0
        for i in parts:
            if load[i] < load[p]:
                p = i
        out[v] = p
        load[p] += d + 1
    return _result(graph, np.asarray(out, dtype=np.int32), num_parts, 1.0,
                   "balanced-only", t0)


def hash_partition(graph: CSRGraph, num_parts: int) -> PartitionResult:
    """Modulo partition, the weakest baseline."""
    t0 = time.perf_counter()
    assignment = (np.arange(graph.num_nodes) % num_parts).astype(np.int32)
    return _result(graph, assignment, num_parts, 1.0, "hash", t0)
