"""Synthetic graph generators.

R-MAT [Chakrabarti et al., SDM'04] is the generator the paper uses for its
scalability study (§6.3). Sampling is the reference's numpy recipe, seeded
the same way, so the graphs are bit-identical to ``repro.graph.generators``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr


def rmat_edges(
    num_nodes: int,
    num_edges: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> np.ndarray:
    """Vectorized R-MAT edge sampling. num_nodes is rounded up to a power of 2
    internally; ids are taken mod num_nodes so the output range is exact."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(num_nodes, 2)))))
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    p_src1 = c + (1.0 - a - b - c)  # P(src bit = 1)
    for _ in range(scale):
        src_bit = rng.random(num_edges) < p_src1
        p_dst1_given0 = b / (a + b)
        p_dst1_given1 = (1.0 - a - b - c) / (c + (1.0 - a - b - c))
        p = np.where(src_bit, p_dst1_given1, p_dst1_given0)
        dst_bit = rng.random(num_edges) < p
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    src %= num_nodes
    dst %= num_nodes
    return np.stack([src, dst], axis=1)


def rmat_graph(
    num_nodes: int,
    avg_degree: int = 10,
    *,
    seed: int = 0,
    undirected: bool = True,
    weighted: bool = False,
    device="cuda",
) -> CSRGraph:
    edges = rmat_edges(num_nodes, num_nodes * avg_degree, seed=seed)
    weights = None
    if weighted:
        # Paper appendix 8.1: weights uniform at random from [1, 5).
        rng = np.random.default_rng(seed + 1)
        weights = rng.uniform(1.0, 5.0, size=len(edges)).astype(np.float32)
    return build_csr(edges, num_nodes, undirected=undirected, weights=weights,
                     device=device)


def undirected_edges(graph: CSRGraph) -> np.ndarray:
    """(m, 2) undirected edge list (u < v) recovered from the CSR arcs, on
    the host."""
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    indices = graph.indices.cpu().numpy().astype(np.int64)
    src = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    keep = src < indices
    return np.stack([src[keep], indices[keep]], axis=1)


def churn_batch(graph: CSRGraph, frac: float = 0.05, *, seed: int = 0,
                pool_frac: float = 0.08, delete_share: float = 0.04):
    """Synthetic localized edge churn, the reference's draw for draw (the
    same numpy generator calls in the same order, so both packages mutate
    the same edges).

    ``frac`` of the undirected edges change, concentrated in a pool of the
    ``pool_frac`` lowest-degree (nonzero) vertices, as a community updating
    or a cohort joining concentrates real churn: ``delete_share`` of the
    changes are deletions of pool-incident edges, lowest degree-sum first;
    the rest are fresh intra-pool insertions. Returns a
    ``repro_torch.graph.delta.EdgeBatch``."""
    from repro_torch.graph.delta import EdgeBatch

    rng = np.random.default_rng(seed)
    und = undirected_edges(graph)
    deg = graph.degrees().cpu().numpy().astype(np.int64)
    n = graph.num_nodes
    n_total = max(1, int(frac * len(und)))
    n_del = max(1, int(n_total * delete_share))
    n_ins = max(0, n_total - n_del)

    nonzero = np.nonzero(deg > 0)[0]
    pool_sz = max(8, int(pool_frac * n))
    pool = nonzero[np.argsort(deg[nonzero], kind="stable")][:pool_sz]
    in_pool = np.zeros(n, bool)
    in_pool[pool] = True

    cand = und[in_pool[und[:, 0]] | in_pool[und[:, 1]]]
    order = np.argsort(deg[cand[:, 0]] + deg[cand[:, 1]], kind="stable")
    delete = cand[order[:min(n_del, len(cand))]]

    # Fresh intra-pool pairs. Membership by pair code u * n + v (u < v): the
    # reference's sets of tuples, with the same answers.
    code = lambda e: (e[:, 0] * np.int64(n) + e[:, 1]).tolist()
    existing = set(code(und))                          # und is already u < v
    dele_set = set(code(np.sort(delete, axis=1)))
    seen = set()
    ins = []
    tries = 0
    while len(ins) < n_ins and tries < 50 * max(n_ins, 1):
        tries += 1
        a, b = rng.choice(pool, 2, replace=False)
        lo, hi = (int(a), int(b)) if a < b else (int(b), int(a))
        key = lo * n + hi
        if key in existing or key in seen or key in dele_set:
            continue
        seen.add(key)
        ins.append((lo, hi))
    insert = np.asarray(ins, np.int64).reshape(-1, 2) if ins else np.zeros((0, 2), np.int64)
    return EdgeBatch(insert=insert, delete=delete)
