"""Graph statistics used by the paper's heuristics and by MPGP's report.

HuGE's walk-count heuristic (Eq. 6) compares the node-degree distribution
p(v) with the corpus-occurrence distribution q(v) by relative entropy;
``edge_locality`` and ``partition_balance`` score a partition (paper
§3.2, Fig. 10). Host numpy over the graph's arrays, the reference's
formulas in the same order, so the values are bit-identical to
``repro.graph.stats``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def degree_distribution(graph: CSRGraph) -> np.ndarray:
    """p(v) = deg(v) / sum_deg (Eq. 6 numerator)."""
    deg = graph.degrees().cpu().numpy().astype(np.float64)
    total = deg.sum()
    if total == 0:
        return np.zeros_like(deg)
    return deg / total


def occurrence_distribution(ocn: np.ndarray) -> np.ndarray:
    """q(v) = ocn(v) / sum ocn (Eq. 6 denominator)."""
    ocn = np.asarray(ocn, dtype=np.float64)
    total = ocn.sum()
    if total == 0:
        return np.zeros_like(ocn)
    return ocn / total


def relative_entropy(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """D(p || q) = sum p log(p/q), guarded against zeros (Eq. 6)."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    mask = p > 0
    return float(np.sum(p[mask] * np.log((p[mask]) / (q[mask] + eps))))


def powerlaw_alpha_mle(degrees: np.ndarray, dmin: int = 1) -> float:
    """Continuous MLE for the power-law exponent of the degree tail."""
    deg = np.asarray(degrees, dtype=np.float64)
    deg = deg[deg >= dmin]
    if deg.size == 0:
        return float("nan")
    return 1.0 + deg.size / np.sum(np.log(deg / (dmin - 0.5)))


def edge_locality(graph: CSRGraph, assignment: np.ndarray) -> float:
    """Fraction of arcs whose both endpoints land in the same partition: the
    quantity MPGP maximizes (a walker that stays local sends no message)."""
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    indices = graph.indices.cpu().numpy().astype(np.int64)
    n = len(indptr) - 1
    src = np.repeat(np.arange(n, dtype=np.int64), indptr[1:] - indptr[:-1])
    a = np.asarray(assignment)
    same = a[src] == a[indices]
    return float(np.mean(same)) if len(same) else 1.0


def partition_balance(assignment: np.ndarray, num_parts: int) -> float:
    """max partition size / mean partition size (1.0 = perfectly balanced)."""
    counts = np.bincount(np.asarray(assignment), minlength=num_parts)
    return float(counts.max() / max(counts.mean(), 1e-9))
