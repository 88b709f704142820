"""Link-prediction AUC of dot-product scores (paper §6, Table 4).

The reference scorer's semantics and random draws (``benchmarks/common.py``
``link_prediction_auc``): the same ``rng`` calls in the same order, so the
same pairs and the same AUC for the same embeddings. Only the non-edge
test differs: a binary search in the sorted arc keys u*|V|+v instead of a
Python set of every arc, which would take minutes at |V| ~ 1e6.
"""

from __future__ import annotations

import numpy as np
import torch


def link_prediction_auc(graph, phi, rng: np.random.Generator,
                        n_pairs: int = 2000) -> float:
    """AUC of phi[u].phi[v]: sampled positive arcs vs sampled non-edges.
    ``phi`` is a tensor on any device, or a numpy array."""
    if isinstance(phi, np.ndarray):
        phi = torch.from_numpy(np.array(phi))     # a writable copy
    indptr = graph.indptr.cpu().numpy()
    indices = graph.indices.cpu().numpy()
    n = graph.num_nodes
    src = np.repeat(np.arange(n), np.diff(indptr))
    pos_idx = rng.choice(len(src), size=min(n_pairs, len(src)), replace=False)
    pos = np.stack([src[pos_idx], indices[pos_idx]], 1)
    arc_keys = src.astype(np.int64) * n + indices     # sorted: CSR row order
    neg = []
    while len(neg) < len(pos):
        a, b = rng.integers(0, n, 2)
        if a == b:
            continue
        key = int(a) * n + int(b)
        i = np.searchsorted(arc_keys, key)
        if i < len(arc_keys) and arc_keys[i] == key:
            continue
        neg.append((a, b))
    neg = np.array(neg)
    rows = torch.as_tensor(np.concatenate([pos, neg]).reshape(-1),
                           device=phi.device)
    emb = phi[rows].cpu().numpy().reshape(2, len(pos), 2, -1)
    s_pos = (emb[0, :, 0] * emb[0, :, 1]).sum(-1)
    s_neg = (emb[1, :, 0] * emb[1, :, 1]).sum(-1)
    diff = s_pos[:, None] - s_neg[None, :]
    return float((diff > 0).mean() + 0.5 * (diff == 0).mean())
