"""Walk engine of the PyTorch port against the JAX reference.

Walks whose acceptance and termination use no transcendental function
(DeepWalk and node2vec with ``info_mode="fixed"``) are compared bit for
bit. HuGE + InCoM uses ``tanh`` and ``log2``, which torch and XLA round
differently in the last bits, so it is held per op and by distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import incom as jax_incom
from repro.core.api import EmbedConfig as JaxEmbedConfig
from repro.core.api import sample_corpus as jax_sample_corpus
from repro.core.corpus import FrequencyOrder as JaxFrequencyOrder
from repro.core.info import relative_entropy_dpq
from repro.core.transition import make_policy as jax_make_policy
from repro.core.transition import row_contains as jax_row_contains
from repro.core.walker import WalkSpec as JaxWalkSpec
from repro.core.walker import run_walk_batch as jax_run_walk_batch
from repro_torch import prng
from repro_torch.core import incom
from repro_torch.core.api import EmbedConfig, sample_corpus
from repro_torch.core.corpus import FrequencyOrder
from repro_torch.core.transition import make_policy, row_contains
from repro_torch.core.walker import STEP_KEY_WINDOW, LaneKeys, WalkSpec, run_walk_batch
from repro_torch.graph.generators import rmat_graph

# Small CPU tensors, and several test workers share the cores: one
# intra-op thread each keeps torch's thread pool from spinning against them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_port():
    return rmat_graph(256, 8, seed=7, device="cpu")


@pytest.mark.parametrize("method,p,q", [("deepwalk", 1.0, 1.0),
                                        ("node2vec", 2.0, 0.5)])
def test_fixed_mode_walks_bit_exact(small_graph, small_port, method, p, q):
    kw = dict(max_len=24, info_mode="fixed", fixed_len=24, max_supersteps=0)
    sources = np.arange(small_graph.num_nodes, dtype=np.int32)
    ref = jax_run_walk_batch(small_graph, jnp.asarray(sources), jax.random.PRNGKey(5),
                             jax_make_policy(method, p=p, q=q), JaxWalkSpec(**kw))
    got = run_walk_batch(small_port, torch.as_tensor(sources, dtype=torch.int64),
                         LaneKeys.of([prng.PRNGKey(5)], len(sources), len(sources), "cpu"),
                         make_policy(method, p=p, q=q), WalkSpec(**kw))
    np.testing.assert_array_equal(np.asarray(ref.path), got.path.numpy())
    np.testing.assert_array_equal(np.asarray(ref.info.L), got.info.L.numpy())
    assert int(ref.supersteps) == got.supersteps
    assert int(ref.accepts) == int(got.accepts)
    assert int(ref.rejects) == int(got.rejects)


def test_fixed_mode_corpus_bit_exact(small_graph, small_port):
    """Rounds, ring appends and occurrence counts: DeepWalk, routine config."""
    kw = dict(method="deepwalk", info_termination=False, fixed_len=16,
              fixed_rounds=3, seed=4)
    ref = jax_sample_corpus(small_graph, JaxEmbedConfig(**kw))
    got = sample_corpus(small_port, EmbedConfig(**kw), device="cpu")
    np.testing.assert_array_equal(ref.walks, got.walks)
    np.testing.assert_array_equal(ref.lengths, got.lengths)
    np.testing.assert_array_equal(ref.ocn, got.ocn)
    assert ref.rounds == got.rounds == 3
    assert ref.stats["supersteps"] == got.stats["supersteps"]


def test_frequency_order_matches_reference():
    rng = np.random.default_rng(8)
    ocn = rng.integers(0, 6, 300)                 # many ties: stable order matters
    walks = rng.integers(-1, 300, (20, 9)).astype(np.int32)
    ref, got = JaxFrequencyOrder.from_ocn(ocn), FrequencyOrder.from_ocn(ocn)
    for name in ("to_rank", "to_node", "sorted_ocn"):
        np.testing.assert_array_equal(getattr(ref, name), getattr(got, name))
    np.testing.assert_array_equal(ref.relabel_walks(walks), got.relabel_walks(walks))
    for a, b in zip(ref.hotness_blocks(), got.hotness_blocks()):
        np.testing.assert_array_equal(a, b)


def test_row_contains_bit_exact(medium_graph):
    port = rmat_graph(1024, 10, seed=3, device="cpu")
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 1024, 5000)
    vals = np.where(rng.random(5000) < 0.5, rng.integers(0, 1024, 5000),
                    np.asarray(medium_graph.indices)[rng.integers(0, port.num_edges, 5000)])
    want = np.asarray(jax_row_contains(medium_graph, jnp.asarray(rows, jnp.int32),
                                       jnp.asarray(vals, jnp.int32)))
    got = row_contains(port, torch.as_tensor(rows), torch.as_tensor(vals))
    np.testing.assert_array_equal(want, got.numpy())
    assert want.any() and not want.all()


def _info_inputs(seed, b=20000):
    rng = np.random.default_rng(seed)
    L = rng.integers(1, 100, b).astype(np.float32)
    n = np.minimum(rng.integers(0, 12, b), L.astype(np.int64)).astype(np.int32)
    H = (rng.random(b) * np.log2(L)).astype(np.float32)
    f = lambda scale: (rng.random(b) * scale).astype(np.float32)
    state = dict(H=H, L=L, EH=f(3), EL=L / 2, EHL=f(100), EH2=f(9),
                 EL2=(L * L / 3).astype(np.float32))
    return n, state, f(5)


def test_entropy_step_within_a_few_ulp():
    """Theorem 1 is a difference of x*log2(x) terms of magnitude up to ~700;
    torch's and XLA's log2 differ in the last bit on many lanes. Held to
    2e-6 absolute (4 ULP of float32 at the entropies' scale, ~8 bits)."""
    n, s, _ = _info_inputs(0)
    want = np.asarray(jax_incom.entropy_step(jnp.asarray(s["H"]), jnp.asarray(s["L"]),
                                             jnp.asarray(n)))
    got = incom.entropy_step(torch.from_numpy(s["H"]), torch.from_numpy(s["L"]),
                             torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    x = np.concatenate([s["L"], n.astype(np.float32), [0.0]]).astype(np.float32)
    np.testing.assert_array_max_ulp(
        incom._xlogx(torch.from_numpy(x)).numpy()[x > 1],
        np.asarray(jax_incom._xlogx(jnp.asarray(x)))[x > 1], maxulp=4)


@pytest.mark.parametrize("reg_start", [1, 16])
def test_stats_step_and_r_squared_exact(reg_start):
    """Eq. 13 and Eq. 12 use no transcendental function: bit-exact."""
    _, s, h_new = _info_inputs(1)
    l_new = s["L"] + 1.0
    ref = jax_incom.stats_step(jax_incom.InfoState(**{k: jnp.asarray(v) for k, v in s.items()}),
                               jnp.asarray(h_new), jnp.asarray(l_new), reg_start)
    got = incom.stats_step(incom.InfoState(**{k: torch.from_numpy(v) for k, v in s.items()}),
                           torch.from_numpy(h_new), torch.from_numpy(l_new), reg_start)
    for k in s:
        np.testing.assert_array_equal(np.asarray(getattr(ref, k)), getattr(got, k).numpy())
    np.testing.assert_array_equal(np.asarray(jax_incom.r_squared(ref)),
                                  incom.r_squared(got).numpy())


def test_huge_incom_walks_by_distribution(medium_graph):
    """HuGE + InCoM corpora: mean walk length within 2%, and the relative
    entropy between the two occurrence-count distributions near zero."""
    kw = dict(max_len=40, min_len=10, delta=1e-3, seed=1)
    ref = jax_sample_corpus(medium_graph, JaxEmbedConfig(**kw))
    port = rmat_graph(1024, 10, seed=3, device="cpu")
    got = sample_corpus(port, EmbedConfig(**kw), device="cpu")
    mean_ref, mean_got = ref.lengths.mean(), got.lengths.mean()
    assert abs(mean_got - mean_ref) <= 0.02 * mean_ref, (mean_got, mean_ref)
    assert relative_entropy_dpq(ref.ocn, got.ocn) < 0.01
    assert abs(ref.rounds - got.rounds) <= 2


# --- walks above one reference chunk ----------------------------------------
# The reference walks a round in chunks of 4,096 sources, each under its own
# key; the port walks them in one device batch. Two full chunks and a ragged
# third (2 * 4096 + 517 nodes), low degree and short walks to stay fast.
BIG_N = 2 * 4096 + 517


@pytest.fixture(scope="module")
def big_graphs():
    from repro.graph.generators import rmat_graph as jax_rmat_graph
    return jax_rmat_graph(BIG_N, 3, seed=11), rmat_graph(BIG_N, 3, seed=11, device="cpu")


@pytest.mark.parametrize("method,p,q", [("deepwalk", 1.0, 1.0), ("node2vec", 4.0, 0.25)])
def test_pipeline_round_above_one_chunk_bit_exact(big_graphs, method, p, q):
    """Two walk rounds of the streaming pipeline in fixed mode: the port's
    ring is the reference's, bit for bit. node2vec's rejections stretch a
    round past 64 supersteps, so the port derives its step keys in more
    than one window."""
    from repro.core.dsgl import DSGLConfig as JaxDSGLConfig
    from repro.runtime.trainer import StreamingEmbedPipeline as JaxPipeline
    from repro_torch.core.dsgl import DSGLConfig
    from repro_torch.runtime.trainer import StreamingEmbedPipeline
    jax_graph, graph = big_graphs
    kw = dict(max_len=10, info_mode="fixed", fixed_len=10)
    rounds = dict(delta=-1.0, min_rounds=2, max_rounds=2)
    ref = JaxPipeline(jax_graph, jax_make_policy(method, p=p, q=q), JaxWalkSpec(**kw),
                      rounds, JaxDSGLConfig(dim=4, seed=3))
    got = StreamingEmbedPipeline(graph, make_policy(method, p=p, q=q), WalkSpec(**kw),
                                 rounds, DSGLConfig(dim=4, seed=3))
    for r in range(2):
        ref._append(ref._run_round(r), r)
        got._append(got._run_round(r), r)
    np.testing.assert_array_equal(np.asarray(ref.ring.walks), got.ring.walks.numpy())
    np.testing.assert_array_equal(np.asarray(ref.ring.lengths), got.ring.lengths.numpy())
    np.testing.assert_array_equal(np.asarray(ref.ring.ocn), got.ring.ocn.numpy())
    assert (np.asarray(ref.ring.lengths)[:BIG_N] > 1).mean() > 0.5   # the walks move
    assert int(ref._stats["accepts"]) == got.stats()["accepts"]
    assert int(ref._stats["rejects"]) == got.stats()["rejects"]
    if method == "node2vec":
        assert max(got.batch_supersteps) > STEP_KEY_WINDOW


def test_sample_corpus_above_one_chunk_bit_exact(big_graphs):
    """The two-phase sampler keys its chunks by a split chain: the same
    corpus from both packages above 4,096 sources."""
    jax_graph, graph = big_graphs
    kw = dict(method="deepwalk", info_termination=False, fixed_len=8,
              fixed_rounds=2, seed=2)
    ref = jax_sample_corpus(jax_graph, JaxEmbedConfig(**kw))
    got = sample_corpus(graph, EmbedConfig(**kw), device="cpu")
    np.testing.assert_array_equal(ref.walks, got.walks)
    np.testing.assert_array_equal(ref.lengths, got.lengths)
    np.testing.assert_array_equal(ref.ocn, got.ocn)
