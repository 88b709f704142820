"""The port's HuGE-D baseline configurations (``repro_torch.core.huge_d``)
against the reference's ``core/huge_d.py``: the four specs field by field,
and ``generate_corpus_huge_d`` on ``small_graph``, bit-exact under
``routine_spec`` with DeepWalk, by distribution for HuGE walks under
``huge_d_spec`` (the full-path info mode), as the port's parity rules
hold walks whose acceptance uses transcendentals."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import huge_d
from repro_torch.core.transition import make_policy
from repro_torch.graph.generators import rmat_graph

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

SPECS = ("huge_d_spec", "distger_spec", "incremental_spec", "routine_spec")


@pytest.fixture(scope="module")
def small_port():
    return rmat_graph(256, 8, seed=7, device="cpu")


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("kwargs", [{}, "custom"])
def test_specs_equal_reference_field_by_field(name, kwargs):
    from repro.core import huge_d as ref_huge_d

    if kwargs == "custom":
        kwargs = ({"fixed_len": 24} if name == "routine_spec" else
                  {"max_len": 40, "min_len": 10, "mu": 0.99, "reg_start": 4})
    want = getattr(ref_huge_d, name)(**kwargs)
    got = getattr(huge_d, name)(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]


def test_routine_corpus_bit_exact(small_graph, small_port):
    """DeepWalk under ``routine_spec`` (fixed length, no transcendental in
    acceptance or termination): walks, lengths, ocn and rounds equal."""
    from repro.core import huge_d as ref_huge_d

    kw = dict(delta=1e-3, min_rounds=2, max_rounds=4, seed=4)
    want = ref_huge_d.generate_corpus_huge_d(small_graph, policy="deepwalk",
                                             spec=ref_huge_d.routine_spec(16), **kw)
    got = huge_d.generate_corpus_huge_d(small_port, policy=make_policy("deepwalk"),
                                        spec=huge_d.routine_spec(16), **kw)
    np.testing.assert_array_equal(want.walks, got.walks)
    np.testing.assert_array_equal(want.lengths, got.lengths)
    np.testing.assert_array_equal(want.ocn, got.ocn)
    assert want.rounds == got.rounds


def test_huge_d_corpus_by_distribution(small_graph, small_port):
    """HuGE walks under ``huge_d_spec`` (the full-path H and R, policy by
    name, as the reference defaults it): mean walk length within 2%, the
    occurrence counts' relative entropy near zero, rounds within 2."""
    from repro.core import huge_d as ref_huge_d
    from repro.core.info import relative_entropy_dpq

    kw = dict(delta=1e-3, max_rounds=6, seed=1)
    want = ref_huge_d.generate_corpus_huge_d(
        small_graph, spec=ref_huge_d.huge_d_spec(max_len=40, min_len=10), **kw)
    got = huge_d.generate_corpus_huge_d(
        small_port, spec=huge_d.huge_d_spec(max_len=40, min_len=10), **kw)
    mean_want, mean_got = want.lengths.mean(), got.lengths.mean()
    assert abs(mean_got - mean_want) <= 0.02 * mean_want, (mean_got, mean_want)
    assert relative_entropy_dpq(want.ocn, got.ocn) < 0.01
    assert abs(want.rounds - got.rounds) <= 2
    assert (got.lengths < 40).any()          # the information test ended walks early
