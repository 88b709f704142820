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
from typing import List, Optional, Tuple

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


# --- elastic reconfiguration: a shard's death and its re-join ----------------


def _load_of(deg: np.ndarray, tau_weight: str) -> np.ndarray:
    """The load each node adds to Eq. 15's capacity term."""
    return deg + 1 if tau_weight == "degree" else np.ones(len(deg), dtype=np.int64)


def reassign_dead_shard(
    graph: CSRGraph,
    assignment: np.ndarray,
    dead: int,
    *,
    num_parts: Optional[int] = None,
    gamma: float = 2.0,
    use_ps2: bool = True,
    tau_weight: str = "degree",
) -> np.ndarray:
    """Stream the nodes of a lost shard (the orphans) into the survivors by
    the partition's own Eq. 14/15 argmax. The survivors' nodes stay where
    they are; the orphans stream highest degree first, with Eq. 15's loads
    primed from the survivors' current ones. Returns a new assignment over
    the original ids with no node on ``dead`` (``compact_assignment`` makes
    the ids dense). Bit-identical to the reference's."""
    asn = np.asarray(assignment, dtype=np.int32)
    if num_parts is None:         # a shard may own no node: callers that know k pass it
        num_parts = int(asn.max()) + 1
    if not 0 <= dead < num_parts:
        raise ValueError(f"dead shard {dead} out of range for {num_parts}")
    if num_parts <= 1:
        raise ValueError("cannot reassign the only shard")
    g = HostCSR.of(graph, with_cm=use_ps2)
    deg = g.indptr[1:] - g.indptr[:-1]

    new_asn = asn.copy()
    orphans = np.flatnonzero(new_asn == dead)
    new_asn[orphans] = -1
    order = orphans[np.argsort(-deg[orphans], kind="stable")]
    counts = np.zeros(num_parts, dtype=np.int64)
    placed = np.flatnonzero(new_asn >= 0)
    np.add.at(counts, new_asn[placed], _load_of(deg, tau_weight)[placed])
    allowed = np.ones(num_parts, dtype=bool)
    allowed[dead] = False
    _assign_stream(g, order, new_asn, counts, num_parts, gamma, use_ps2, tau_weight,
                   allowed=allowed)
    assert not np.any(new_asn == dead) and not np.any(new_asn < 0)
    return new_asn


def compact_assignment(assignment: np.ndarray, dead: int, *,
                       num_parts: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Shift the ids above ``dead`` down by one, after ``reassign_dead_shard``,
    so the k-1 survivors are dense in [0, k-1). Returns ``(compacted,
    old_of_new)``, ``old_of_new[i]`` survivor i's original id."""
    asn = np.asarray(assignment, dtype=np.int32)
    if np.any(asn == dead):
        raise ValueError(f"assignment still references dead shard {dead}")
    if num_parts is None:
        num_parts = max(int(asn.max()) + 1 if asn.size else 0, dead + 1)
    compacted = np.where(asn > dead, asn - 1, asn).astype(np.int32)
    old_of_new = np.array([p for p in range(num_parts) if p != dead], dtype=np.int32)
    return compacted, old_of_new


def _bfs_donors(g: HostCSR, asn: np.ndarray, load_of: np.ndarray, surplus: np.ndarray,
                seed: int, target: float) -> np.ndarray:
    """The reference's donor search, a level at a time: a FIFO breadth-first
    search from ``seed`` pops the nodes level by level, each level's nodes
    in the order their parents popped and, under one parent, in row order,
    so each level is its predecessor's unvisited neighbours, first
    occurrences kept. A popped node donates while its shard's surplus is
    positive (``surplus`` is updated in place); the search stops at the
    first pop that brings the donated load to ``target``.

    Within a level a shard's donors are a prefix of its nodes there (loads
    are positive), so each node's test is its shard's surplus less the
    loads of the shard's nodes before it in the level. Every such float64
    value equals the reference's sequential one while it is positive (an
    integer taken from a float below 2**53 leaves an exact result), so the
    donors are the reference's, in its order."""
    indptr, indices = g.indptr, g.indices
    visited = np.zeros(len(asn), dtype=bool)
    visited[seed] = True
    level = np.array([seed], dtype=np.int64)
    donors: List[np.ndarray] = []
    donated = 0
    while len(level) and donated < target:
        part, load = asn[level], load_of[level]
        by_part = np.argsort(part, kind="stable")
        ps, ls = part[by_part], load[by_part]
        before = np.cumsum(ls) - ls
        first = np.r_[True, ps[1:] != ps[:-1]]
        excl = np.empty_like(before)
        excl[by_part] = before - before[first][np.cumsum(first) - 1]
        gives = surplus[part] - excl > 0
        given = donated + np.cumsum(np.where(gives, load, 0))
        reached = np.flatnonzero(given >= target)
        end = int(reached[0]) + 1 if len(reached) else len(level)
        take = gives[:end]
        donors.append(level[:end][take])
        np.subtract.at(surplus, part[:end][take], load[:end][take].astype(np.float64))
        donated = int(given[end - 1])
        if len(reached):
            break
        starts = indptr[level]
        width = indptr[level + 1] - starts
        arcs = np.repeat(starts - (np.cumsum(width) - width), width) + np.arange(int(width.sum()))
        nbr = indices[arcs]
        nbr = nbr[~visited[nbr]]
        _, at = np.unique(nbr, return_index=True)
        level = nbr[np.sort(at)]
        visited[level] = True
    return np.concatenate(donors) if donors else np.zeros(0, dtype=np.int64)


def rejoin_shard(
    graph: CSRGraph,
    assignment: np.ndarray,
    *,
    num_parts: Optional[int] = None,
    gamma: float = 2.0,
    tau_weight: str = "degree",
) -> Tuple[np.ndarray, np.ndarray]:
    """Grow a k-way assignment to k+1 when a lost shard returns; the new
    shard takes id ``num_parts`` (survivors' ids never move). Donors are
    found by a breadth-first search from the most loaded survivor's
    highest-degree node: a node donates while its shard holds more than the
    (k+1)-way share of the load, until the new shard holds one share. The
    donors then stream, highest degree first, into the new shard alone
    (``allowed`` admits it only; PS2 is skipped, the argmax having one
    candidate). Returns ``(new_assignment, moved_mask)``, both bit-identical
    to the reference's, whose search pops a ``deque`` one node at a time
    (``_bfs_donors`` does it a level at a time)."""
    asn = np.asarray(assignment, dtype=np.int32)
    if num_parts is None:
        num_parts = int(asn.max()) + 1
    if np.any(asn < 0) or np.any(asn >= num_parts):
        raise ValueError("assignment must be dense in [0, num_parts)")
    k_new = num_parts + 1
    g = HostCSR.of(graph, with_cm=False)
    deg = g.indptr[1:] - g.indptr[:-1]
    load_of = _load_of(deg, tau_weight)

    counts = np.zeros(k_new, dtype=np.int64)
    np.add.at(counts, asn, load_of)
    target = counts.sum() / k_new
    surplus = counts[:num_parts].astype(np.float64) - target
    heavy = int(np.argmax(counts[:num_parts]))
    members = np.flatnonzero(asn == heavy)
    seed = int(members[np.argmax(deg[members])])
    donor_ids = _bfs_donors(g, asn, load_of, surplus, seed, target)
    if not len(donor_ids):
        donor_ids = np.array([seed], dtype=np.int64)     # never re-open an empty shard

    new_asn = asn.copy()
    new_asn[donor_ids] = -1
    counts2 = np.zeros(k_new, dtype=np.int64)
    placed = np.flatnonzero(new_asn >= 0)
    np.add.at(counts2, new_asn[placed], load_of[placed])
    order = donor_ids[np.argsort(-deg[donor_ids], kind="stable")]
    allowed = np.zeros(k_new, dtype=bool)
    allowed[num_parts] = True
    _assign_stream(g, order, new_asn, counts2, k_new, gamma, use_ps2=False,
                   tau_weight=tau_weight, allowed=allowed)
    assert not np.any(new_asn < 0) and np.any(new_asn == num_parts)
    return new_asn, new_asn != asn


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
