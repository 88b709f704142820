"""Incremental embedding refresh after edge churn (the dynamic-graph path).

The lifecycle, as the reference's ``repro.core.incremental`` runs it:

    mutate  — churn batches accumulate in a ``graph.delta.DeltaCSR``
              overlay; a refresh compacts it (with the incremental Cm);
    detect  — the affected vertices are read off the device corpus ring
              (``incom.paths_traverse_edges`` / ``paths_visit_nodes``):
              the churn's endpoints plus the roots of recorded walks that
              traverse a changed arc;
    re-walk — only affected roots walk again, one subset batch per retained
              round under that round's key; vertex-keyed RNG makes each
              walk the one a full round on the mutated graph would give, and
              ``corpus.ring_replace`` puts it in its predecessor's slot;
    gate    — the Eq. 7 ΔD controller continues from the prior run's D_r
              history and appends subset rounds while D moves;
    tune    — DSGL fine-tunes in place over the refreshed ring (K1 in the
              pipeline's CUDA graphs), with the alias table rebuilt from
              the exact refreshed ``ocn``.

Detection modes: ``"traversal"`` (a stored walk is stale iff it traverses
a changed arc; plus every churn endpoint) and ``"paranoid"`` (also every
root whose walk visits the closed neighbourhood of the churn, after which
every kept walk is provably the one a from-scratch walk would give).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import incom
from repro_torch.device import synced_clock
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.delta import DeltaCSR, EdgeBatch


def changed_arc_codes(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Sorted row-major arc codes of both directions of ``edges`` (host)."""
    if len(edges) == 0:
        return np.zeros(0, np.int64)
    e = np.asarray(edges, np.int64)
    arcs = np.concatenate([e, e[:, ::-1]], axis=0)
    return np.unique(arcs[:, 0] * np.int64(num_nodes) + arcs[:, 1])


def closed_neighborhood(graph: CSRGraph, nodes) -> torch.Tensor:
    """(|V|,) bool on the graph's device: ``nodes`` and all their neighbours."""
    dev = graph.device
    mark = torch.zeros(graph.num_nodes, dtype=torch.bool, device=dev)
    nodes = torch.as_tensor(np.asarray(nodes, np.int64)).to(dev)
    nodes = nodes[nodes < graph.num_nodes]
    mark[nodes] = True
    deg = graph.degrees()[nodes]
    total = int(deg.sum())
    if total:
        owner = torch.repeat_interleave(torch.arange(len(nodes), device=dev), deg,
                                        output_size=total)
        pos = torch.arange(total, device=dev) - (torch.cumsum(deg, 0) - deg)[owner]
        mark[graph.indices[graph.indptr[nodes][owner] + pos]] = True
    return mark


def affected_roots(walks: torch.Tensor, roots, changed_edges: np.ndarray,
                   touched: np.ndarray, num_nodes: int, *, mode: str = "traversal",
                   old_graph: Optional[CSRGraph] = None,
                   new_graph: Optional[CSRGraph] = None) -> np.ndarray:
    """(num_nodes,) bool (host numpy): the vertices whose walks must be
    walked again. ``walks`` are recorded (-1 padded) corpus rows, on any
    device, and ``roots`` their source vertices. Read off the corpus alone:
    detection never steps the walk engine."""
    if mode not in ("traversal", "paranoid"):
        raise ValueError(f"unknown detection mode {mode!r}")
    dev = walks.device
    affected = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
    touched = torch.as_tensor(np.asarray(touched, np.int64)).to(dev)
    affected[touched[touched < num_nodes]] = True
    if len(walks):
        roots = torch.as_tensor(roots).to(dev, torch.int64)
        codes = torch.from_numpy(changed_arc_codes(changed_edges, num_nodes)).to(dev)
        affected[roots[incom.paths_traverse_edges(walks, codes, num_nodes)]] = True
        if mode == "paranoid":
            mark = closed_neighborhood(old_graph, touched)
            if new_graph is not None:
                mark |= closed_neighborhood(new_graph, touched)[:num_nodes]
            affected[roots[incom.paths_visit_nodes(walks, mark)]] = True
    return affected.cpu().numpy()


@dataclasses.dataclass
class RefreshStats:
    """Cost and quality record of one refresh. ``rewalk_supersteps`` sums,
    over the refresh's walk batches (one per retained round re-walked, one
    per extra round), the supersteps each batch ran: the most any of its
    lanes needed. The reference sums over its 4,096-source chunks instead,
    so the two agree where every re-walk set fits one chunk. ``phase_s``:
    host wall seconds of compact (merge and Cm; ``cm`` alone), detect,
    rewalk, topup and finetune, each ending in a device sync."""

    changed_edges: int
    churn_frac: float              # changed edges / undirected edges before the churn
    affected: int
    affected_frac: float           # affected roots / |V|
    retained_rounds: int
    extra_rounds: int
    rewalk_walks: int              # walks re-simulated (roots x rounds)
    rewalk_supersteps: int
    fine_tune_steps: int
    wall_s: float
    mode: str = "full"
    phase_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class IncrementalRefresh:
    """Owns the mutate -> detect -> re-walk -> fine-tune lifecycle around one
    ``StreamingEmbedPipeline`` and one ``DeltaCSR`` overlay. The pipeline
    must walk with ``WalkSpec.rng_mode == "vertex"``;
    ``core.api.embed_graph(..., return_state=True)`` arranges it."""

    def __init__(self, pipeline, delta: Optional[DeltaCSR] = None, *,
                 detect: str = "traversal"):
        if pipeline.spec.rng_mode != "vertex":
            raise ValueError("incremental refresh needs vertex-keyed walk RNG "
                             "(WalkSpec.rng_mode='vertex'); re-embed with "
                             "embed_graph(..., return_state=True)")
        self.pipeline = pipeline
        self.delta = delta if delta is not None else DeltaCSR(pipeline.graph)
        self.detect = detect
        self.last_stats: Optional[RefreshStats] = None
        self.last_affected_mask: Optional[np.ndarray] = None

    def apply_updates(self, batch: EdgeBatch) -> "IncrementalRefresh":
        """Stage one churn batch in the overlay (no refresh yet)."""
        self.delta.apply_batch(batch)
        return self

    def refresh(self, *, mode: str = "full", extra_affected: Optional[np.ndarray] = None,
                **kwargs) -> RefreshStats:
        """Absorb all staged churn: compact the overlay, detect the affected
        vertices from the corpus, re-walk them, fine-tune DSGL in place.

        ``mode``: ``"full"``; ``"no_finetune"`` skips the fine-tune and the
        ΔD top-up rounds (walks exact, phi lags); ``"detect_only"`` detects
        and adopts the graph only, the ring keeps its stale walks and the
        caller carries ``last_affected_mask`` as debt. ``extra_affected`` is
        that debt: a (|V|,) bool mask OR-ed into this refresh's set."""
        if mode not in ("full", "no_finetune", "detect_only"):
            raise ValueError(f"unknown refresh mode {mode!r}")
        pipe = self.pipeline
        dev = pipe.device
        t0 = time.perf_counter()
        old_graph = pipe.graph
        n_old = old_graph.num_nodes
        if self.delta.num_nodes != n_old:
            # Before the churn log drains or the overlay compacts: a refused
            # refresh leaves the refresher as it was.
            raise ValueError(f"staged churn grows the vertex set ({self.delta.num_nodes} != "
                             f"{n_old}), which refresh_embedding cannot absorb yet; rebuild "
                             "with embed_graph on the mutated graph")
        arcs_und = old_graph.num_edges / 2.0
        ins, dele = self.delta.take_changes()
        changed = np.concatenate([ins, dele], axis=0)
        touched = np.unique(changed.reshape(-1)) if len(changed) else np.zeros(0, np.int64)
        new_graph = self.delta.compact()
        t1 = synced_clock(dev)
        phase = {"compact": t1 - t0, "cm": self.delta.cm_seconds}

        walks, roots, valid = pipe.corpus_slots()
        if not valid.all():
            rows = torch.from_numpy(np.nonzero(valid)[0]).to(dev)
            walks = walks[rows]
        affected_mask = affected_roots(walks, roots[valid], changed, touched, n_old,
                                       mode=self.detect, old_graph=old_graph,
                                       new_graph=new_graph)
        del walks
        if extra_affected is not None:
            affected_mask = affected_mask | np.asarray(extra_affected, bool)
        self.last_affected_mask = affected_mask.copy()
        phase["detect"] = synced_clock(dev) - t1

        if mode == "detect_only":
            pipe.adopt_graph(new_graph)
            body = {"affected": int(affected_mask.sum()),
                    "affected_frac": float(affected_mask.mean()),
                    "retained_rounds": 0, "extra_rounds": 0, "rewalk_walks": 0,
                    "rewalk_supersteps": 0, "fine_tune_steps": 0}
        else:
            if mode == "no_finetune":
                kwargs = {**kwargs, "fine_tune_steps": 0, "max_extra_rounds": 0}
            body = pipe.refresh(new_graph, affected_mask, **kwargs)
            phase.update(body.pop("phase_s"))
        stats = RefreshStats(changed_edges=int(len(changed)),
                             churn_frac=float(len(changed) / max(arcs_und, 1.0)),
                             mode=mode, wall_s=float(time.perf_counter() - t0),
                             phase_s=phase, **body)
        self.last_stats = stats
        return stats

    def embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.pipeline.embeddings()
