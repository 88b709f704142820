"""CSR graph container (paper §2: "DistGER uses the CSR format").

Undirected edges are stored twice (both directions), directed once.
Neighbour lists are sorted, so membership and intersection are binary
searches. The arrays are tensors on one device; ``indptr`` and
``indices`` are int64 so they index without conversion.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# Wedges (arc, scanned neighbour) tested per pass of ``edge_common_neighbors``:
# bounds its int64 temporaries to a few hundred MB each.
WEDGE_CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency.

    indptr:  (|V|+1,) int64 — row offsets
    indices: (|E|,)   int64 — sorted neighbour ids per row
    weights: (|E|,)   float32 or None — edge weights (None = unweighted)
    edge_cm: (|E|,)   int32 or None — per-edge common-neighbour counts
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    weights: Optional[torch.Tensor] = None
    edge_cm: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        """Number of stored directed arcs (2x undirected edge count)."""
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def to(self, device) -> "CSRGraph":
        dev = resolve_device(device)
        move = lambda t: None if t is None else t.to(dev)
        return CSRGraph(move(self.indptr), move(self.indices),
                        move(self.weights), move(self.edge_cm))

    def with_edge_cm(self) -> "CSRGraph":
        if self.edge_cm is not None:
            return self
        return dataclasses.replace(self, edge_cm=edge_common_neighbors(self))


def build_csr(
    edges: np.ndarray,
    num_nodes: Optional[int] = None,
    *,
    undirected: bool = True,
    weights: Optional[np.ndarray] = None,
    dedup: bool = True,
    device="cuda",
) -> CSRGraph:
    """Build a CSR graph from an (m, 2) int edge array.

    Self-loops are dropped. With ``undirected=True`` each edge is stored in
    both directions. Neighbour lists come out sorted. The host side is the
    reference's numpy recipe, so the arrays are bit-identical to it."""
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be (m, 2), got {edges.shape}")
    mask = edges[:, 0] != edges[:, 1]
    edges = edges[mask]
    w = None
    if weights is not None:
        w = np.asarray(weights, dtype=np.float32)[mask]

    if undirected:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
        if w is not None:
            w = np.concatenate([w, w], axis=0)

    if num_nodes is None:
        num_nodes = int(edges.max()) + 1 if edges.size else 0

    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges = edges[order]
    if w is not None:
        w = w[order]

    if dedup and edges.size:
        keep = np.ones(len(edges), dtype=bool)
        keep[1:] = np.any(edges[1:] != edges[:-1], axis=1)
        edges = edges[keep]
        if w is not None:
            w = w[keep]

    counts = np.bincount(edges[:, 0], minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    return CSRGraph(
        indptr=torch.from_numpy(indptr).to(dev),
        indices=torch.from_numpy(np.ascontiguousarray(edges[:, 1])).to(dev),
        weights=None if w is None else torch.from_numpy(w).to(dev),
    )


def edge_common_neighbors(graph: CSRGraph, wedge_chunk: int = WEDGE_CHUNK,
                          arcs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-arc common-neighbour counts Cm(u, v), CSR-aligned, int32; with
    ``arcs`` (int64 arc ids) the counts of those arcs only, in their order.

    For each arc the shorter of N(u), N(v) is scanned and each of its
    entries is searched in the longer one (``transition.row_contains``, a
    binary search of as many steps as the longest row needs). The (arc,
    entry) wedges are expanded in chunks of ``wedge_chunk`` on the graph's
    device and the hits summed per arc: the same integer counts as the
    reference's per-arc loop."""
    from repro_torch.core.transition import row_contains

    indptr, indices = graph.indptr, graph.indices
    dev = indices.device
    n = graph.num_nodes
    deg = graph.degrees()
    src = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                  output_size=graph.num_edges)
    dst = indices
    if arcs is not None:
        src, dst = src[arcs], dst[arcs]
    m = int(src.shape[0])
    cm = torch.zeros(m, dtype=torch.int32, device=dev)
    if m == 0:
        return cm
    scan_src = deg[src] <= deg[dst]
    scanned = torch.where(scan_src, src, dst)          # row walked entry by entry
    searched = torch.where(scan_src, dst, src)         # row searched in
    width = deg[scanned]
    ends = torch.cumsum(width, 0)                      # wedge index past each arc
    ends_host = ends.cpu().numpy()
    steps = int(deg.max()).bit_length()                # enough to search the longest row

    lo = 0
    while lo < m:
        base = int(ends_host[lo - 1]) if lo else 0
        hi = int(np.searchsorted(ends_host, base + wedge_chunk, side="right"))
        hi = max(hi, lo + 1)
        nw = int(ends_host[hi - 1]) - base
        if nw:
            arc = torch.repeat_interleave(
                torch.arange(lo, hi, device=dev), width[lo:hi], output_size=nw)
            pos = (torch.arange(nw, device=dev) + base
                   - (ends[arc] - width[arc]))          # entry within its row
            vals = indices[indptr[scanned[arc]] + pos]
            hit = row_contains(graph, searched[arc], vals, steps)
            cm[lo:hi] = torch.zeros(hi - lo, dtype=torch.int32, device=dev
                                    ).index_add_(0, arc - lo, hit.to(torch.int32))
        lo = hi
    return cm


# --- the partition-local store of the sharded walk engine --------------------


def subgraph_partition_pad(graph: CSRGraph, assignment: np.ndarray, num_parts: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Split a CSR graph into per-partition padded CSR slices, stacked:
    (indptr_p, indices_p, owned_nodes_p, max_nodes), host numpy. Node ids
    stay global; each partition stores the adjacency of the nodes it owns."""
    parts = _partition_slices(graph, assignment, num_parts)
    return parts["indptr"], parts["indices"], parts["owned"], parts["max_nodes"]


def _node_layout(deg: np.ndarray, asn: np.ndarray, num_parts: int):
    """The node-level layout of a partition, O(|V|) on the host: per part
    node counts, the padded width, each node's local row at its owner, the
    owned nodes by local row (-1 pad) and the local row offsets. Rows are
    in ascending global id within a part."""
    n = len(deg)
    counts = np.bincount(asn, minlength=num_parts)
    max_nodes = max(int(counts.max()), 1) if n else 1
    node_starts = np.zeros(num_parts + 1, np.int64)
    np.cumsum(counts, out=node_starts[1:])
    order = np.argsort(asn, kind="stable")       # ascending ids within a part
    local_of = np.empty(max(n, 1), np.int64)
    local_of[order] = np.arange(n) - np.repeat(node_starts[:-1], counts)
    owned = np.full((num_parts, max_nodes), -1, np.int64)
    deg_p = np.zeros((num_parts, max_nodes), np.int64)
    if n:
        owned[asn, local_of[:n]] = np.arange(n)
        deg_p[asn, local_of[:n]] = deg
    indptr_p = np.zeros((num_parts, max_nodes + 1), np.int64)
    np.cumsum(deg_p, axis=1, out=indptr_p[:, 1:])
    return counts, max_nodes, local_of, owned, indptr_p


def _partition_slices(graph: CSRGraph, assignment: np.ndarray, num_parts: int) -> dict:
    """Per-partition CSR slicing on the host, O(|V| + |E|). Within a
    partition rows are in ascending global id and keep their sorted
    neighbour lists, so the slice row of node v is its global row."""
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    indices = graph.indices.cpu().numpy().astype(np.int64)
    n = len(indptr) - 1
    asn = np.asarray(assignment, np.int64)
    deg = indptr[1:] - indptr[:-1]
    counts, max_nodes, local_of, owned, indptr_p = _node_layout(deg, asn, num_parts)

    # Arcs are src-major in ascending src, so a stable sort by partition
    # keeps each partition's arcs in its local-row order: the indptr_p layout.
    src = np.repeat(np.arange(n), deg)
    arc_order = np.argsort(asn[src], kind="stable") if len(src) else src
    e_counts = np.bincount(asn[src], minlength=num_parts).astype(np.int64)
    max_edges = max(int(e_counts.max()), 1) if len(src) else 1
    e_starts = np.zeros(num_parts + 1, np.int64)
    np.cumsum(e_counts, out=e_starts[1:])
    arc_p = asn[src][arc_order]
    arc_pos = np.arange(len(src)) - np.repeat(e_starts[:-1], e_counts)
    dst = indices[arc_order]

    def edge_aligned(values, fill, dtype):
        out = np.full((num_parts, max_edges), fill, dtype)
        if len(src):
            out[arc_p, arc_pos] = values
        return out

    return {
        "indptr": indptr_p, "indices": edge_aligned(dst, -1, np.int64), "owned": owned,
        "max_nodes": max_nodes, "local_of": local_of[:n], "num_owned": counts.astype(np.int64),
        "deg": deg, "arc_dst": dst, "edge_aligned": edge_aligned, "arc_order": arc_order,
    }


@dataclasses.dataclass(frozen=True)
class ShardCSR:
    """The k shards' padded CSR slices in local row ids, stacked on a
    leading shard axis, with arc-aligned halo metadata (neighbour owner and
    degree), so phase A of a walk step never reads a global O(|E|) array.

    indptr:    (k, max_nodes+1) int32 — local row offsets
    indices:   (k, max_edges)   int32 — global neighbour ids (-1 pad)
    nbr_owner: (k, max_edges)   int32 — the shard owning each neighbour
    nbr_deg:   (k, max_edges)   int32 — each neighbour's degree (HuGE Eq. 3)
    weights:   (k, max_edges)   float32 or None
    edge_cm:   (k, max_edges)   int32 or None — Cm(u, v)
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    nbr_owner: torch.Tensor
    nbr_deg: torch.Tensor
    weights: Optional[torch.Tensor] = None
    edge_cm: Optional[torch.Tensor] = None

    def take(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        """``field[s, idx[s, j]]`` for every shard s: one gather on the
        flattened field (``idx`` is (k, P))."""
        arr = getattr(self, name)
        k, width = arr.shape
        base = torch.arange(k, device=idx.device)[:, None] * width
        return arr.reshape(-1)[idx + base]


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """The partition-local graph store: stacked ``ShardCSR`` slices of
    O(|V|/k + |E|/k) each, plus the O(|V|) node metadata the walk engine
    needs, replicated like the assignment itself."""

    slices: ShardCSR
    local_of: torch.Tensor        # (|V|,) int64: global node -> local row at its owner
    owned: np.ndarray             # (k, max_nodes) int64, host: local row -> global node
    num_owned: np.ndarray         # (k,) int64, host
    num_parts: int

    def shard_csr_nbytes(self) -> np.ndarray:
        """Bytes per shard of the CSR slice proper: indptr and indices, with
        the weights and Cm where present."""
        s = self.slices
        per = sum(t.shape[-1] * t.element_size()
                  for t in (s.indptr, s.indices, s.weights, s.edge_cm) if t is not None)
        return np.full(self.num_parts, per, np.int64)


def build_partitioned_csr(graph: CSRGraph, assignment: np.ndarray,
                          num_parts: int) -> PartitionedCSR:
    """The partition-local store the sharded walk engine runs on, on the
    graph's device: each shard's slice holds its owned nodes' adjacency in
    local rows, neighbour ids global (they name the message destination
    and the path entry), and the per-arc neighbour owner and degree."""
    parts = _partition_slices(graph, assignment, num_parts)
    asn = np.asarray(assignment, np.int64)
    dst, edge_aligned, arc_order = parts["arc_dst"], parts["edge_aligned"], parts["arc_order"]
    dev = graph.device
    as_dev = lambda a, dtype: torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)
    nbr_owner = edge_aligned(asn[dst] if len(dst) else dst, -1, np.int64)
    nbr_deg = edge_aligned(parts["deg"][dst] if len(dst) else dst, 0, np.int64)
    weights = edge_cm = None
    if graph.weights is not None:
        w = graph.weights.cpu().numpy().astype(np.float32)[arc_order]
        weights = as_dev(edge_aligned(w, 0.0, np.float32), torch.float32)
    if graph.edge_cm is not None:
        cm = graph.edge_cm.cpu().numpy().astype(np.int64)[arc_order]
        edge_cm = as_dev(edge_aligned(cm, 0, np.int64), torch.int32)
    slices = ShardCSR(indptr=as_dev(parts["indptr"], torch.int32),
                      indices=as_dev(parts["indices"], torch.int32),
                      nbr_owner=as_dev(nbr_owner, torch.int32),
                      nbr_deg=as_dev(nbr_deg, torch.int32),
                      weights=weights, edge_cm=edge_cm)
    return PartitionedCSR(slices=slices, local_of=as_dev(parts["local_of"], torch.int64),
                          owned=parts["owned"], num_owned=parts["num_owned"],
                          num_parts=num_parts)


def reassign_partitioned_csr(graph: CSRGraph, new_assignment: np.ndarray, num_parts: int, *,
                             old: PartitionedCSR, old_assignment: np.ndarray,
                             old_of_new: np.ndarray) -> Tuple[PartitionedCSR, int]:
    """Rebuild a ``PartitionedCSR`` after an elastic reconfiguration, on the
    graph's device, reusing what did not change.

    ``new_assignment`` is either a shard death's compacted k-1-way
    assignment (``mpgp.reassign_dead_shard`` + ``compact_assignment``) or
    a re-join's k+1-way one (``mpgp.rejoin_shard``); ``old`` is the store it
    replaces and ``old_of_new[s]`` new shard s's old id, -1 for a new
    shard. A shard that neither gained nor lost a node keeps its arc rows
    (indices, neighbour degrees, weights, Cm), copied on the device from
    the old slices and refit to the new padded width; a changed shard's
    rows are scattered from the graph's arcs. ``nbr_owner`` is recomputed
    for every shard (an arc into a moved node changes owner), and the
    O(|V|) node layout outright. Returns ``(store, reused)``, ``reused`` the
    shards whose rows were copied; the store equals
    ``build_partitioned_csr(graph, new_assignment, num_parts)`` field for
    field."""
    dev = graph.device
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    n = len(indptr) - 1
    asn = np.asarray(new_assignment, np.int64)
    old_asn = np.asarray(old_assignment, np.int64)
    old_of_new = np.asarray(old_of_new, np.int64)
    deg = indptr[1:] - indptr[:-1]
    counts, max_nodes, local_of, owned, indptr_p = _node_layout(deg, asn, num_parts)
    e_counts = np.zeros(num_parts, np.int64)
    np.add.at(e_counts, asn, deg)
    max_edges = max(int(e_counts.max()), 1) if indptr[-1] else 1

    # A node moved iff its old shard is not its new shard's old id (a new
    # shard's -1 matches none). A shard is rebuilt iff it gained a moved
    # node (a death's survivors) or, surviving, lost one (a re-join's donors).
    changed = old_of_new < 0
    if n:
        moved = old_of_new[asn] != old_asn
        if moved.any():
            changed[np.unique(asn[moved])] = True
            new_of_old = np.full(1 + int(max(old_asn.max(), old_of_new.max())), -1, np.int64)
            keep = old_of_new >= 0
            new_of_old[old_of_new[keep]] = np.flatnonzero(keep)
            losers = new_of_old[old_asn[moved]]
            changed[np.unique(losers[losers >= 0])] = True

    s = old.slices
    fields = ("indices", "nbr_deg", "weights", "edge_cm")
    fill = {"indices": -1, "nbr_deg": 0, "weights": 0.0, "edge_cm": 0}
    rows = {f: None if getattr(s, f) is None else
            torch.full((num_parts, max_edges), fill[f], dtype=getattr(s, f).dtype, device=dev)
            for f in fields}
    reused = 0
    width = min(max_edges, int(s.indices.shape[1]))     # only padding lies beyond
    for p in np.flatnonzero(~changed):
        o = int(old_of_new[p])
        for f, t in rows.items():
            if t is not None:
                t[p, :width] = getattr(s, f)[o, :width]
        reused += 1

    asn_t = torch.from_numpy(asn).to(dev)
    if n and changed.any():
        deg_t = graph.degrees()
        src = torch.repeat_interleave(torch.arange(n, device=dev), deg_t,
                                      output_size=graph.num_edges)
        arc = torch.nonzero(torch.from_numpy(changed).to(dev)[asn_t[src]]).squeeze(1)
        src = src[arc]
        part = asn_t[src]
        # A node's row starts at its local row's offset in its owner's slice.
        pos = (torch.from_numpy(indptr_p).to(dev)[part, torch.from_numpy(local_of[:n]).to(dev)[src]]
               + arc - graph.indptr[src])
        dst = graph.indices[arc]
        rows["indices"][part, pos] = dst.to(rows["indices"].dtype)
        rows["nbr_deg"][part, pos] = deg_t[dst].to(rows["nbr_deg"].dtype)
        for f in ("weights", "edge_cm"):
            if rows[f] is not None:
                rows[f][part, pos] = getattr(graph, f)[arc].to(rows[f].dtype)

    idx = rows["indices"]
    nbr_owner = torch.where(idx >= 0, asn_t[idx.clamp(min=0).to(torch.int64)],
                            -1).to(s.nbr_owner.dtype)
    slices = ShardCSR(indptr=torch.from_numpy(indptr_p).to(s.indptr.dtype).to(dev),
                      indices=idx, nbr_owner=nbr_owner, nbr_deg=rows["nbr_deg"],
                      weights=rows["weights"], edge_cm=rows["edge_cm"])
    store = PartitionedCSR(slices=slices, local_of=torch.from_numpy(local_of[:n]).to(dev),
                           owned=owned, num_owned=counts.astype(np.int64), num_parts=num_parts)
    return store, reused
