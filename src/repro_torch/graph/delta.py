"""Delta-CSR edge churn: batched insert/delete overlay over ``CSRGraph``.

The storage half of the dynamic-graph lifecycle (``core.incremental`` is
the refresh half), the reference's ``repro.graph.delta`` rule for rule:

* ``EdgeBatch``: one batch of undirected edge inserts and deletes (host
  numpy: churn arrives from the host).
* ``DeltaCSR``: an overlay on a base ``CSRGraph``. A batch costs
  O(|Δ| log |E|) on the host (deletes tombstone base arcs found by a binary
  search over the sorted row-major arc codes; inserts append to a pending
  list). The merged ``graph()`` view is built once per mutation as a
  ``CSRGraph`` on the base graph's device, and ``compact()`` promotes it
  into the new base.
* ``incremental_edge_cm``: Cm(u, v) after churn. Arcs with no touched
  endpoint copy their old count by a row-offset gather; the rest are
  recounted on the device by ``csr.edge_common_neighbors(..., arcs=)``.
* ``graph_version`` / ``bump_graph_version``: a mutation counter that the
  walk engine's caches key on, so a mutated graph is never served a stale
  ``PartitionedCSR`` or pool size (``core.shard_engine``).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import synced_clock
from repro_torch.graph.csr import CSRGraph, edge_common_neighbors

# ---------------------------------------------------------------------------
# Graph mutation versions (cache-invalidation contract)
# ---------------------------------------------------------------------------

# id(graph) -> [version, weakref]. The weakref guards id() recycling: a dead
# referent means the id may belong to a new object, which must start from a
# version later than anything the dead object reported.
_VERSIONS: dict = {}
_NEXT_VERSION = [1]


def graph_version(graph: object) -> int:
    """Mutation counter of ``graph`` (0 = never registered). Cache keys that
    pair ``id(graph)`` with it stay correct across in-place mutation."""
    ent = _VERSIONS.get(id(graph))
    if ent is None or ent[1]() is not graph:
        return 0
    return ent[0]


def bump_graph_version(graph: object) -> int:
    """Register a new mutation of ``graph``; returns the new version."""
    v = _NEXT_VERSION[0]
    _NEXT_VERSION[0] += 1
    _VERSIONS[id(graph)] = [v, weakref.ref(graph)]
    if len(_VERSIONS) > 256:             # drop dead entries, bounded housekeeping
        for k in [k for k, e in _VERSIONS.items() if e[1]() is None]:
            _VERSIONS.pop(k, None)
    return v


# ---------------------------------------------------------------------------
# Edge batches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """One batch of undirected edge churn (host numpy).

    insert:  (mi, 2) int: edges to add (self-loops dropped, duplicates of
             existing edges ignored).
    delete:  (md, 2) int: edges to remove (missing edges ignored).
    insert_weights: optional (mi,) float32 weights of the inserted edges.
    """

    insert: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))
    delete: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))
    insert_weights: Optional[np.ndarray] = None

    def __post_init__(self):
        object.__setattr__(self, "insert", np.asarray(self.insert, np.int64).reshape(-1, 2))
        object.__setattr__(self, "delete", np.asarray(self.delete, np.int64).reshape(-1, 2))
        if self.insert_weights is not None:
            object.__setattr__(self, "insert_weights",
                               np.asarray(self.insert_weights, np.float32).reshape(-1))

    @property
    def num_changes(self) -> int:
        return int(len(self.insert) + len(self.delete))

    def changed_edges(self) -> np.ndarray:
        """(m, 2) union of inserted and deleted edges (one direction each)."""
        return np.concatenate([self.insert, self.delete], axis=0)


def validate_edge_batch(batch: EdgeBatch, num_nodes: int, *, self_loops: str = "drop",
                        duplicates: str = "allow") -> EdgeBatch:
    """Admission control for a churn batch, before it is applied.

    Always rejected: vertex ids outside [0, num_nodes), non-finite insert
    weights, a weights vector whose length differs from ``insert``'s.
    ``self_loops`` and ``duplicates`` (repeated undirected pairs within the
    batch's inserts) are each ``"drop"`` (filtered), ``"forbid"`` (raise)
    or ``"allow"`` (passed on; the CSR drops self-loops and duplicate arcs
    anyway). Returns the batch, filtered where a policy dropped rows."""
    if self_loops not in ("drop", "forbid", "allow"):
        raise ValueError(f"unknown self_loops policy {self_loops!r}")
    if duplicates not in ("drop", "forbid", "allow"):
        raise ValueError(f"unknown duplicates policy {duplicates!r}")
    for name in ("insert", "delete"):
        arr = getattr(batch, name)
        if arr.size and (arr.min() < 0 or arr.max() >= num_nodes):
            bad = arr[np.any((arr < 0) | (arr >= num_nodes), axis=1)]
            raise ValueError(f"EdgeBatch.{name}: {len(bad)} edge(s) reference vertices "
                             f"outside [0, {num_nodes}), e.g. {bad[0].tolist()}")
    w = batch.insert_weights
    if w is not None:
        if len(w) != len(batch.insert):
            raise ValueError(f"EdgeBatch.insert_weights has {len(w)} entries for "
                             f"{len(batch.insert)} inserted edges")
        if not np.all(np.isfinite(w)):
            raise ValueError(f"EdgeBatch.insert_weights: {int(np.sum(~np.isfinite(w)))} "
                             "non-finite value(s) (they would reach the alias table)")

    ins, dele = batch.insert, batch.delete
    loops_i = ins[:, 0] == ins[:, 1]
    loops_d = dele[:, 0] == dele[:, 1]
    if self_loops == "forbid" and (loops_i.any() or loops_d.any()):
        raise ValueError(f"EdgeBatch contains {int(loops_i.sum() + loops_d.sum())} "
                         "self-loop(s) and the self-loop policy is 'forbid'")
    if self_loops == "drop" and (loops_i.any() or loops_d.any()):
        ins = ins[~loops_i]
        if w is not None:
            w = w[~loops_i]
        dele = dele[~loops_d]

    if duplicates != "allow" and len(ins):
        und = np.sort(ins, axis=1)
        _, first = np.unique(und[:, 0] * np.int64(max(num_nodes, 1)) + und[:, 1],
                             return_index=True)
        if len(first) != len(ins):
            if duplicates == "forbid":
                raise ValueError(f"EdgeBatch.insert contains {len(ins) - len(first)} "
                                 "duplicate undirected edge(s) and the duplicate policy "
                                 "is 'forbid'")
            keep = np.sort(first)               # keep the first, in order
            ins = ins[keep]
            if w is not None:
                w = w[keep]

    if ins is batch.insert and dele is batch.delete:
        return batch
    return EdgeBatch(insert=ins, delete=dele, insert_weights=w)


def _both_directions(edges: np.ndarray, w: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    arcs = np.concatenate([edges, edges[:, ::-1]], axis=0)
    if w is not None:
        w = np.concatenate([w, w], axis=0)
    return arcs, w


def _arc_codes(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Row-major arc codes; the base CSR's arcs are sorted under them."""
    return src.astype(np.int64) * np.int64(max(n, 1)) + dst.astype(np.int64)


def _host(t: Optional[torch.Tensor], dtype) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy().astype(dtype)


# ---------------------------------------------------------------------------
# The overlay
# ---------------------------------------------------------------------------


class DeltaCSR:
    """Batched insert/delete overlay with periodic compaction.

    The base graph is never mutated; ``graph()`` returns merged ``CSRGraph``
    views on the base's device (a new object per mutation) and ``compact()``
    promotes the current view to the new base. ``take_changes()`` drains the
    churn log accumulated since the last drain: the input of affected-vertex
    detection. ``cm_seconds`` is the wall time of the last view's Cm."""

    def __init__(self, base: CSRGraph, *, undirected: bool = True,
                 compact_threshold: float = 0.25):
        self.device = base.device
        self._set_base(base)
        self.undirected = undirected
        self.compact_threshold = float(compact_threshold)
        self._view: Optional[CSRGraph] = None
        self._log_insert: list = []
        self._log_delete: list = []
        self.version = 0
        self.compactions = 0
        self.cm_seconds = 0.0

    def _set_base(self, g: CSRGraph) -> None:
        self._indptr = _host(g.indptr, np.int64)
        self._indices = _host(g.indices, np.int64)
        self._weights = _host(g.weights, np.float32)    # owned: resurrection re-prices it
        self._edge_cm = _host(g.edge_cm, np.int32)
        self._num_nodes = len(self._indptr) - 1
        self._deleted = np.zeros(len(self._indices), bool)
        self._ext_src = np.zeros(0, np.int64)
        self._ext_dst = np.zeros(0, np.int64)
        self._ext_w = None if self._weights is None else np.zeros(0, np.float32)
        self._codes: Optional[np.ndarray] = None        # per-base-epoch memo
        self._base_src: Optional[np.ndarray] = None
        self._codes_n = -1

    # -- introspection -----------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    @property
    def pending_arcs(self) -> int:
        """Overlay size: tombstoned base arcs + pending inserted arcs."""
        return int(self._deleted.sum()) + len(self._ext_src)

    def _base_codes(self) -> np.ndarray:
        """Sorted row-major codes of the base arcs, memoized per base epoch
        (they change only at ``compact()`` or vertex growth), which keeps
        ``apply_batch`` at O(|Δ| log |E|)."""
        if self._codes is None or self._codes_n != self._num_nodes:
            self._base_src = np.repeat(np.arange(len(self._indptr) - 1, dtype=np.int64),
                                       np.diff(self._indptr))
            self._codes = _arc_codes(self._base_src, self._indices, self._num_nodes)
            self._codes_n = self._num_nodes
        return self._codes

    # -- mutation ----------------------------------------------------------
    def apply_batch(self, batch: EdgeBatch) -> "DeltaCSR":
        """Apply one churn batch to the overlay. O(|Δ| log |E|)."""
        ins = batch.insert[batch.insert[:, 0] != batch.insert[:, 1]]
        dele = batch.delete[batch.delete[:, 0] != batch.delete[:, 1]]
        w_ins = batch.insert_weights
        if w_ins is not None:
            w_ins = w_ins[batch.insert[:, 0] != batch.insert[:, 1]]
        if self.undirected:
            del_arcs, _ = _both_directions(dele)
            ins_arcs, w_arcs = _both_directions(ins, w_ins)
        else:
            del_arcs, ins_arcs, w_arcs = dele, ins, w_ins

        if len(ins_arcs):                       # inserts may name new vertices
            top = int(ins_arcs.max()) + 1
            if top > self._num_nodes:
                self._indptr = np.concatenate(
                    [self._indptr, np.full(top - self._num_nodes, self._indptr[-1], np.int64)])
                self._num_nodes = top
        n = self._num_nodes
        codes = self._base_codes()

        if len(del_arcs):
            # An endpoint outside the vertex set names a missing edge, and
            # must go before encoding: u n + v with v >= n is another arc's code.
            del_arcs = del_arcs[((del_arcs >= 0) & (del_arcs < n)).all(axis=1)]
        if len(del_arcs):
            want = _arc_codes(del_arcs[:, 0], del_arcs[:, 1], n)
            pos_c = np.minimum(np.searchsorted(codes, want), max(len(codes) - 1, 0))
            found = (len(codes) > 0) & (codes[pos_c] == want)
            self._deleted[pos_c[found & ~self._deleted[pos_c]]] = True
            if len(self._ext_src):              # deletes cancel pending inserts too
                keep = ~np.isin(_arc_codes(self._ext_src, self._ext_dst, n), want)
                self._ext_src, self._ext_dst = self._ext_src[keep], self._ext_dst[keep]
                if self._ext_w is not None:
                    self._ext_w = self._ext_w[keep]

        if len(ins_arcs):
            want = _arc_codes(ins_arcs[:, 0], ins_arcs[:, 1], n)
            pos_c = np.minimum(np.searchsorted(codes, want), max(len(codes) - 1, 0))
            hit = (len(codes) > 0) & (codes[pos_c] == want)
            in_base = hit & ~self._deleted[pos_c]
            # A re-inserted base arc is un-tombstoned, and takes the insert's
            # weight (the caller may have re-priced it).
            was_deleted = hit & self._deleted[pos_c]
            self._deleted[pos_c[was_deleted]] = False
            if self._weights is not None and was_deleted.any():
                self._weights[pos_c[was_deleted]] = (
                    w_arcs[was_deleted] if w_arcs is not None
                    else np.ones(int(was_deleted.sum()), np.float32))
            pending = (np.isin(want, _arc_codes(self._ext_src, self._ext_dst, n))
                       if len(self._ext_src) else np.zeros(len(want), bool))
            fresh = ~in_base & ~was_deleted & ~pending
            _, first = np.unique(want[fresh], return_index=True)    # dedup within the batch
            keep_idx = np.nonzero(fresh)[0][np.sort(first)]
            self._ext_src = np.concatenate([self._ext_src, ins_arcs[keep_idx, 0]])
            self._ext_dst = np.concatenate([self._ext_dst, ins_arcs[keep_idx, 1]])
            if self._ext_w is not None:
                self._ext_w = np.concatenate(
                    [self._ext_w, w_arcs[keep_idx] if w_arcs is not None
                     else np.ones(len(keep_idx), np.float32)])

        self._log_insert.append(np.asarray(ins, np.int64))
        self._log_delete.append(np.asarray(dele, np.int64))
        self._invalidate()
        if self.compact_threshold > 0 and \
                self.pending_arcs > self.compact_threshold * max(len(self._indices), 1):
            self.compact()
        return self

    def _invalidate(self) -> None:
        if self._view is not None:
            # A caller may still hand the retired view to the engine caches:
            # bump its version so no (id, version) key of it stays valid.
            bump_graph_version(self._view)
        self._view = None
        self.version += 1

    # -- views and compaction ----------------------------------------------
    def _merged_arrays(self):
        """(indptr, indices, weights) of the merged graph on the host: the
        surviving base arcs, still in code order, with the pending inserts
        inserted at their sorted positions (codes are unique, so this is the
        reference's lexsort by (src, dst))."""
        n = self._num_nodes
        keep = ~self._deleted
        kept = self._base_codes()[keep]
        ext = _arc_codes(self._ext_src, self._ext_dst, n)
        order = np.argsort(ext, kind="stable")
        ext = ext[order]
        at = np.searchsorted(kept, ext)
        codes = np.insert(kept, at, ext)
        w = None
        if self._weights is not None:
            ext_w = self._ext_w if self._ext_w is not None else np.zeros(0, np.float32)
            w = np.insert(self._weights[keep], at, ext_w[order])
        src, dst = np.divmod(codes, np.int64(max(n, 1)))
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
        return indptr, dst, w

    def graph(self) -> CSRGraph:
        """The merged view on the base's device, cached until the next
        mutation; with the incrementally refreshed ``edge_cm`` when the base
        had one."""
        if self._view is not None:
            return self._view
        indptr, indices, w = self._merged_arrays()
        dev = self.device
        up = lambda a, dtype: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
        view = CSRGraph(indptr=up(indptr, torch.int64), indices=up(indices, torch.int64),
                        weights=None if w is None else up(w, torch.float32))
        if self._edge_cm is not None:
            t0 = time.perf_counter()
            old = CSRGraph(indptr=up(self._indptr, torch.int64),
                           indices=up(self._indices, torch.int64),
                           edge_cm=up(self._edge_cm, torch.int32))
            view = dataclasses.replace(
                view, edge_cm=incremental_edge_cm(old, view, self._overlay_touched()))
            self.cm_seconds = synced_clock(dev) - t0
        self._view = view
        return view

    def compact(self) -> CSRGraph:
        """Promote the merged view into the new base; clears the overlay
        (not the churn log: ``take_changes`` owns that)."""
        view = self.graph()
        self._set_base(view)
        self.compactions += 1
        return view

    def _overlay_touched(self) -> np.ndarray:
        """Endpoints of every change now in the overlay (tombstoned base arcs
        and pending inserts): the rows that differ between base and view,
        whatever the churn log's drain state."""
        self._base_codes()                      # ensures _base_src
        parts = [self._base_src[self._deleted], self._indices[self._deleted],
                 self._ext_src, self._ext_dst]
        return (np.unique(np.concatenate(parts)) if any(len(p) for p in parts)
                else np.zeros(0, np.int64))

    # -- churn log ---------------------------------------------------------
    def touched_nodes(self) -> np.ndarray:
        """Distinct endpoints of every change since the last drain."""
        parts = self._log_insert + self._log_delete
        if not parts:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate([p.reshape(-1) for p in parts]))

    def pending_changes(self) -> Tuple[np.ndarray, np.ndarray]:
        """(inserted edges, deleted edges) accumulated since the last drain."""
        ins = np.concatenate(self._log_insert) if self._log_insert \
            else np.zeros((0, 2), np.int64)
        dele = np.concatenate(self._log_delete) if self._log_delete \
            else np.zeros((0, 2), np.int64)
        return ins, dele

    def take_changes(self) -> Tuple[np.ndarray, np.ndarray]:
        """Drain the churn log (once per refresh, so the next one sees only
        new churn)."""
        out = self.pending_changes()
        self._log_insert, self._log_delete = [], []
        return out


# ---------------------------------------------------------------------------
# Incremental Cm(u, v)
# ---------------------------------------------------------------------------


def incremental_edge_cm(old: CSRGraph, new: CSRGraph, touched) -> torch.Tensor:
    """Per-arc common-neighbour counts of ``new`` after churn that touched
    the vertices ``touched``, from ``old``'s counts, on ``new``'s device.

    Cm(u, v) = |N(u) ∩ N(v)| changes only where N(u) or N(v) changed, i.e.
    on arcs with a touched endpoint. An untouched row is the same in both
    graphs, so its counts move by a row-offset gather; the touched ("stale")
    arcs are recounted by ``edge_common_neighbors(new, arcs=stale)``. Equal,
    integer for integer, to ``edge_common_neighbors(new)``."""
    dev = new.device
    n_old, n_new, m = old.num_nodes, new.num_nodes, new.num_edges
    mark = torch.zeros(max(n_old, n_new), dtype=torch.bool, device=dev)
    touched = torch.as_tensor(np.asarray(touched, np.int64)).to(dev)
    mark[touched] = True
    mark[n_old:] = True                         # brand-new vertices
    deg = new.degrees()
    src = torch.repeat_interleave(torch.arange(n_new, device=dev), deg, output_size=m)
    stale = mark[src] | mark[new.indices]
    cm = torch.zeros(m, dtype=torch.int32, device=dev)
    fresh = torch.nonzero(~stale).squeeze(1)
    if len(fresh):
        # Arc j of an untouched u's new row is arc j of its old row.
        offs = fresh - new.indptr[src[fresh]]
        cm[fresh] = old.edge_cm.to(dev)[old.indptr.to(dev)[src[fresh]] + offs]
    arcs = torch.nonzero(stale).squeeze(1)
    if len(arcs):
        cm[arcs] = edge_common_neighbors(new, arcs=arcs)
    return cm
