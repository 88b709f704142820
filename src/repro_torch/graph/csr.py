"""CSR graph container (paper §2: "DistGER uses the CSR format").

Undirected edges are stored twice (both directions), directed once.
Neighbour lists are sorted, so membership and intersection are binary
searches. The arrays are tensors on one device; ``indptr`` and
``indices`` are int64 so they index without conversion.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def edge_common_neighbors(graph: CSRGraph,
                          wedge_chunk: int = WEDGE_CHUNK) -> torch.Tensor:
    """Per-arc common-neighbour counts Cm(u, v), CSR-aligned, int32.

    For each arc the shorter of N(u), N(v) is scanned and each of its
    entries is searched in the longer one (``transition.row_contains``, a
    fixed 32-step binary search). The (arc, entry) wedges are expanded in
    chunks of ``wedge_chunk`` on the graph's device and the hits summed
    per arc: the same integer counts as the reference's per-arc loop."""
    from repro_torch.core.transition import row_contains

    indptr, indices = graph.indptr, graph.indices
    dev = indices.device
    n, m = graph.num_nodes, graph.num_edges
    cm = torch.zeros(m, dtype=torch.int32, device=dev)
    if m == 0:
        return cm
    deg = graph.degrees()
    src = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                  output_size=m)
    scan_src = deg[src] <= deg[indices]
    scanned = torch.where(scan_src, src, indices)      # row walked entry by entry
    searched = torch.where(scan_src, indices, src)     # row searched in
    width = deg[scanned]
    ends = torch.cumsum(width, 0)                      # wedge index past each arc
    ends_host = ends.cpu().numpy()

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
            hit = row_contains(graph, searched[arc], vals)
            cm[lo:hi] = torch.zeros(hi - lo, dtype=torch.int32, device=dev
                                    ).index_add_(0, arc - lo, hit.to(torch.int32))
        lo = hi
    return cm
