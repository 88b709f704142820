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
