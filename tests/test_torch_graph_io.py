"""The port's edge-list IO (``repro_torch.graph.io``): the reference's
``tests/test_graph_io.py`` cases on the port (weighted edge lists,
comments and blank lines, npz, save -> load -> save round trips of a
delta-compacted graph), and each package loading the files the other
wrote to equal arrays."""

import numpy as np
import pytest
import torch

from repro_torch.graph.csr import build_csr
from repro_torch.graph.delta import DeltaCSR, EdgeBatch
from repro_torch.graph.io import load_edge_list, save_edge_list

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)


def _arrays(g):
    return (g.indptr.numpy(), g.indices.numpy(),
            None if g.weights is None else g.weights.numpy())


def _load(path, **kw):
    return load_edge_list(path, device="cpu", **kw)


def test_text_comments_and_blank_lines(tmp_path):
    p = tmp_path / "g.txt"
    p.write_text(
        "# a comment line\n"
        "\n"
        "0 1\n"
        "   \n"
        "1 2\n"
        "# trailing comment\n"
        "2 3\n")
    g = _load(str(p))
    assert g.num_nodes == 4
    assert g.num_edges == 6            # 3 undirected edges, both arcs
    lo, hi = int(g.indptr[1]), int(g.indptr[2])
    np.testing.assert_array_equal(g.indices[lo:hi].numpy(), [0, 2])


def test_weighted_text_round_trip(tmp_path):
    edges = np.array([[0, 1], [1, 2], [0, 3], [2, 3]])
    w = np.array([0.5, 2.0, 1.25, 4.0], np.float32)
    g = build_csr(edges, 4, weights=w, device="cpu")
    p = tmp_path / "w.txt"
    save_edge_list(g, str(p))
    g2 = _load(str(p))
    i1, x1, w1 = _arrays(g)
    i2, x2, w2 = _arrays(g2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(x1, x2)
    assert w1 is not None and w2 is not None
    np.testing.assert_allclose(w1, w2)


def test_weighted_text_parse(tmp_path):
    p = tmp_path / "w.txt"
    p.write_text("0 1 2.5\n1 2 0.75\n")
    g = _load(str(p))
    assert g.weights is not None
    lo = int(g.indptr[0])
    assert float(g.weights[lo]) == 2.5


def test_npz_round_trip(tmp_path):
    edges = np.array([[0, 1], [1, 2], [3, 0]])
    g = build_csr(edges, 5, device="cpu")        # isolated node 4
    p = tmp_path / "g.npz"
    save_edge_list(g, str(p))
    g2 = _load(str(p))
    assert g2.num_nodes == 5
    i1, x1, _ = _arrays(g)
    i2, x2, _ = _arrays(g2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(x1, x2)


@pytest.mark.parametrize("fmt", ["txt", "npz"])
def test_delta_compacted_save_load_save_round_trip(tmp_path, fmt):
    """A graph mutated through the delta overlay and compacted back into
    CSR must survive save -> load -> save with identical bytes."""
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 40, (120, 2))
    g = build_csr(edges, 40, device="cpu")
    d = DeltaCSR(g, compact_threshold=0)
    und_src = np.repeat(np.arange(40), np.diff(g.indptr.numpy()))
    arcs = np.stack([und_src, g.indices.numpy()], 1)
    und = arcs[arcs[:, 0] < arcs[:, 1]]
    d.apply_batch(EdgeBatch(insert=np.array([[0, 39], [5, 31], [7, 11]]), delete=und[:4]))
    compacted = d.compact()

    p1 = tmp_path / f"a.{fmt}"
    p2 = tmp_path / f"b.{fmt}"
    save_edge_list(compacted, str(p1))
    loaded = _load(str(p1), num_nodes=compacted.num_nodes)
    i1, x1, _ = _arrays(compacted)
    i2, x2, _ = _arrays(loaded)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(x1, x2)
    save_edge_list(loaded, str(p2))
    if fmt == "txt":
        assert p1.read_text() == p2.read_text()
    else:
        a, b = np.load(str(p1)), np.load(str(p2))
        np.testing.assert_array_equal(a["edges"], b["edges"])
        assert int(a["num_nodes"]) == int(b["num_nodes"])


@pytest.mark.parametrize("fmt", ["txt", "npz"])
@pytest.mark.parametrize("weighted", [False, True])
def test_each_package_reads_the_others_files(tmp_path, fmt, weighted):
    """The reference's file, loaded by the port, and the port's, loaded by
    the reference, give the writer's arrays; the two packages write the
    same bytes (text) or the same arrays (npz)."""
    from repro.graph.csr import build_csr as ref_build_csr
    from repro.graph.io import load_edge_list as ref_load
    from repro.graph.io import save_edge_list as ref_save

    rng = np.random.default_rng(11)
    edges = rng.integers(0, 60, (200, 2))
    w = rng.uniform(0.5, 4.0, len(edges)).astype(np.float32) if weighted else None
    ref_g = ref_build_csr(edges, 61, weights=w)            # node 60 isolated
    port_g = build_csr(edges, 61, weights=w, device="cpu")
    ref_path, port_path = tmp_path / f"ref.{fmt}", tmp_path / f"port.{fmt}"
    ref_save(ref_g, str(ref_path))
    save_edge_list(port_g, str(port_path))

    ref_np = ref_g.to_numpy()
    want = (np.asarray(ref_np.indptr), np.asarray(ref_np.indices),
            None if ref_np.weights is None else np.asarray(ref_np.weights))
    kw = {"num_nodes": 61} if fmt == "txt" else {}
    got = _arrays(_load(str(ref_path), **kw))              # the port reads the reference's
    back = ref_load(str(port_path), **kw).to_numpy()       # and the reference the port's
    back = (np.asarray(back.indptr), np.asarray(back.indices),
            None if back.weights is None else np.asarray(back.weights))
    for arrays in (got, back):
        np.testing.assert_array_equal(arrays[0], want[0])
        np.testing.assert_array_equal(arrays[1], want[1])
        if weighted:
            np.testing.assert_array_equal(arrays[2], want[2])
        else:
            assert arrays[2] is None
    if fmt == "txt":
        assert ref_path.read_text() == port_path.read_text()
    else:
        a, b = np.load(str(ref_path)), np.load(str(port_path))
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
