"""Edge-list IO (text + npz) for real-graph ingestion, the JAX package's
``graph/io.py`` over the port's ``CSRGraph``. The files are the
reference's, byte for byte: each package reads what the other writes."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr


def load_edge_list(
    path: str,
    *,
    undirected: bool = True,
    num_nodes: Optional[int] = None,
    comment: str = "#",
    device="cuda",
) -> CSRGraph:
    """A ``CSRGraph`` on ``device`` from a text edge list ("src dst" or
    "src dst w" lines; blank lines and ``comment`` lines skipped) or an
    ``.npz`` of ``edges`` (and ``num_nodes``, ``weights`` where saved)."""
    if path.endswith(".npz"):
        data = np.load(path)
        return build_csr(
            data["edges"],
            num_nodes=num_nodes or (int(data["num_nodes"]) if "num_nodes" in data else None),
            undirected=undirected,
            weights=data["weights"] if "weights" in data else None,
            device=device,
        )
    rows = []
    weights = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            parts = line.split()
            rows.append((int(parts[0]), int(parts[1])))
            if len(parts) > 2:
                weights.append(float(parts[2]))
    edges = np.asarray(rows, dtype=np.int64)
    w = np.asarray(weights, dtype=np.float32) if weights else None
    return build_csr(edges, num_nodes, undirected=undirected, weights=w, device=device)


def save_edge_list(graph: CSRGraph, path: str) -> None:
    """Write every stored arc as one edge: text, or ``.npz`` (compressed,
    with ``num_nodes`` and the weights)."""
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    indices = graph.indices.cpu().numpy().astype(np.int64)
    weights = None if graph.weights is None else graph.weights.cpu().numpy()
    n = len(indptr) - 1
    deg = indptr[1:] - indptr[:-1]
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    edges = np.stack([src, indices], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npz"):
        payload = {"edges": edges, "num_nodes": np.int64(n)}
        if weights is not None:
            payload["weights"] = weights
        np.savez_compressed(path, **payload)
    else:
        with open(path, "w") as f:
            if weights is not None:
                # "src dst w", the 3-column form load_edge_list parses; .9g
                # keeps enough digits for exact float32 round-trips.
                for (s, d), w in zip(edges, weights):
                    f.write(f"{s} {d} {w:.9g}\n")
            else:
                for s, d in edges:
                    f.write(f"{s} {d}\n")
