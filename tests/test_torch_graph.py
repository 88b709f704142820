"""Graph substrate of the PyTorch port against the JAX reference: CSR arrays
and per-arc common-neighbour counts, bit for bit."""

import numpy as np
import pytest
import torch

from repro.graph.csr import build_csr as jax_build_csr
from repro.graph.csr import edge_common_neighbors as jax_edge_cm
from repro_torch.graph.csr import build_csr, edge_common_neighbors
from repro_torch.graph.generators import rmat_graph

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)


def _assert_same_csr(ref, got):
    np.testing.assert_array_equal(np.asarray(ref.indptr), got.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(ref.indices), got.indices.numpy())
    assert got.indptr.dtype == torch.int64 and got.indices.dtype == torch.int64


@pytest.mark.parametrize("fixture,args,chunk", [("small_graph", (256, 8, 7), 7),
                                                ("medium_graph", (1024, 10, 3), 4096)])
def test_rmat_csr_and_edge_cm_bit_exact(request, fixture, args, chunk):
    ref = request.getfixturevalue(fixture)
    n, deg, seed = args
    got = rmat_graph(n, deg, seed=seed, device="cpu")
    _assert_same_csr(ref, got)
    cm_ref = jax_edge_cm(ref)
    cm = got.with_edge_cm().edge_cm
    assert cm.dtype == torch.int32
    np.testing.assert_array_equal(cm_ref, cm.numpy())
    # Small wedge chunks exercise the chunk boundaries (an arc wider than a
    # chunk gets a chunk of its own).
    np.testing.assert_array_equal(
        cm_ref, edge_common_neighbors(got, wedge_chunk=chunk).numpy())


def test_build_csr_matches_reference():
    rng = np.random.default_rng(11)
    edges = rng.integers(0, 40, size=(300, 2))      # self-loops and duplicates
    weights = rng.uniform(1, 5, size=300).astype(np.float32)
    for undirected in (True, False):
        ref = jax_build_csr(edges, 45, undirected=undirected, weights=weights)
        got = build_csr(edges, 45, undirected=undirected, weights=weights,
                        device="cpu")
        _assert_same_csr(ref, got)
        np.testing.assert_array_equal(np.asarray(ref.weights), got.weights.numpy())
        assert got.num_nodes == 45 and got.num_edges == ref.num_edges
        np.testing.assert_array_equal(np.asarray(ref.degrees()), got.degrees().numpy())
