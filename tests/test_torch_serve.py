"""The port's embedding server (``repro_torch.runtime.serve``) and its
order-pinned scoring (``repro_torch.kernels.chain_dot``).

The reference's ``tests/test_serve.py``, case for case (the same test
names and parametrisation), against the port's ``EmbedServer`` on the
CPU. Then:

* the scoring's plain versions against the reference's jitted scoring and
  the NumPy oracle, bit for bit, at every d the kernel must take, ragged
  batches and candidate widths, with duplicated rows (ties), zero rows
  (scores of -0.0 and +0.0) and subnormal products;
* one scripted lifecycle under a fake clock through both packages'
  servers on the same checkpoints (a torn step, a rejected candidate, the
  ``swap`` and ``serve_wave`` drills, overflow, a deadline shed): equal
  responses, dtypes and bits included, and equal ``stats()``;
* ``benchmarks/serve.py``'s lifecycle at its quick size on the port:
  churn through the ingest driver, a retry storm, a refresh death, a torn
  candidate and a swap drill, every response bit-equal to the oracle of
  the version it is stamped with;
* nothing falls back: CPU tensors to the kernel's wrapper raise, and a
  server asked for the card raises without one.

On the card (``-m cuda``) the kernel is held to its plain versions bit for
bit.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.ckpt.checkpoint import save_checkpoint
from repro_torch.kernels.chain_dot import ops as chain_ops
from repro_torch.kernels.chain_dot import ref as chain_ref
from repro_torch.runtime.faults import FaultInjector, SimulatedFailure
from repro_torch.runtime.health import SnapshotGate, SnapshotGateConfig
from repro_torch.runtime.serve import (EmbedServer, ServeConfig, ServeError, oracle_scores,
                                       oracle_topk, wave_batches)

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)


def _phi(n=64, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _ckpt(root, step, phi, **meta):
    meta.setdefault("graph_version", 0)
    meta.setdefault("global_step", step)
    return save_checkpoint(str(root), step, {"phi_in": phi}, meta=meta)


def _server(**kw):
    kw.setdefault("cfg", ServeConfig(batch_slots=8))
    kw.setdefault("device", "cpu")
    return EmbedServer(**kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean_registry():
    obs.reset()
    yield
    obs.reset()


# ---------------------------------------------------------------------------
# Oracle bit-identity (the reference's cases)
# ---------------------------------------------------------------------------


class TestBitIdentity:
    @pytest.mark.parametrize("d", [8, 16, 17, 33, 64])
    def test_pair_scores_match_oracle_exactly(self, tmp_path, d):
        phi = _phi(d=d, seed=d)
        _ckpt(tmp_path, 0, phi)
        srv = _server()
        assert srv.offer_snapshot(str(tmp_path))
        rng = np.random.default_rng(d)
        for width in (1, 2, 5, 8, 16):
            cand = rng.integers(0, 64, size=width)
            qid = srv.submit(int(rng.integers(0, 64)), candidates=cand)
            srv.drain()
            r = srv.responses[qid]
            want = oracle_scores(phi, r.u, cand)
            assert np.array_equal(r.scores, want), (d, width)
            assert np.array_equal(r.ids, cand)

    @pytest.mark.parametrize("k", [1, 5, 16])
    def test_topk_matches_oracle_exactly(self, tmp_path, k):
        phi = _phi(seed=k)
        _ckpt(tmp_path, 0, phi)
        srv = _server()
        srv.offer_snapshot(str(tmp_path))
        qids = [srv.submit(u, k=k) for u in (0, 7, 63)]
        srv.drain()
        for qid, u in zip(qids, (0, 7, 63)):
            r = srv.responses[qid]
            vals, ids = oracle_topk(phi, u, k)
            assert np.array_equal(r.scores, vals)
            assert np.array_equal(r.ids, ids)
            assert u not in r.ids          # self excluded

    def test_mixed_wave_groups_do_not_leak_padding(self, tmp_path):
        """One wave mixing top-K and several candidate widths: each
        response is trimmed to its own query's shape and exact."""
        phi = _phi(seed=42)
        _ckpt(tmp_path, 0, phi)
        srv = _server(cfg=ServeConfig(batch_slots=32))
        assert srv.offer_snapshot(str(tmp_path))
        specs = [{"u": 1, "candidates": [2, 3, 4]},
                 {"u": 5, "k": 4},
                 {"u": 9, "candidates": [10]},
                 {"u": 11, "candidates": list(range(20))},
                 {"u": 13, "k": 4}]
        out = srv.serve(specs)
        assert all(r is not None for r in out)
        for spec, r in zip(specs, out):
            if "candidates" in spec:
                assert len(r.scores) == len(spec["candidates"])
                assert np.array_equal(r.scores, oracle_scores(phi, spec["u"],
                                                              spec["candidates"]))
            else:
                vals, ids = oracle_topk(phi, spec["u"], spec["k"])
                assert np.array_equal(r.scores, vals)
                assert np.array_equal(r.ids, ids)

    def test_wave_batches_shapes(self):
        assert [len(w) for w in wave_batches(list(range(10)), 4)] == [4, 4, 2]
        assert list(wave_batches([], 4)) == []


# ---------------------------------------------------------------------------
# Versioned snapshot swap
# ---------------------------------------------------------------------------


class TestSnapshotSwap:
    def test_swap_is_monotone_and_stamped(self, tmp_path):
        a, b = _phi(seed=1), _phi(seed=2)
        _ckpt(tmp_path, 0, a)
        srv = _server()
        assert srv.offer_snapshot(str(tmp_path))
        q0 = srv.submit(3, candidates=[1, 2])
        srv.drain()
        _ckpt(tmp_path, 1, b)
        assert srv.offer_snapshot(str(tmp_path))
        q1 = srv.submit(3, candidates=[1, 2])
        srv.drain()
        assert srv.responses[q0].served_version == 0
        assert srv.responses[q1].served_version == 1
        assert np.array_equal(srv.responses[q0].scores, oracle_scores(a, 3, [1, 2]))
        assert np.array_equal(srv.responses[q1].scores, oracle_scores(b, 3, [1, 2]))
        assert srv.swaps == 2

    def test_reoffer_of_active_version_is_noop(self, tmp_path):
        _ckpt(tmp_path, 0, _phi())
        srv = _server()
        assert srv.offer_snapshot(str(tmp_path))
        assert not srv.offer_snapshot(str(tmp_path))
        assert srv.swaps == 1
        assert srv.stats()["freshness"] == "fresh"

    def test_torn_candidate_falls_back_and_keeps_serving(self, tmp_path):
        """A torn (manifest-less) newer step is invisible: the loader falls
        back to the active version, which keeps serving fresh."""
        phi = _phi(seed=3)
        _ckpt(tmp_path, 0, phi)
        srv = _server()
        srv.offer_snapshot(str(tmp_path))
        torn = tmp_path / "step_00000001"
        torn.mkdir()
        (torn / "phi_in.npy").write_bytes(b"\x93NUMPY garbage")
        assert not srv.offer_snapshot(str(tmp_path))
        assert srv.active_version() == 0
        r = srv.serve([{"u": 2, "candidates": [4, 5]}])[0]
        assert np.array_equal(r.scores, oracle_scores(phi, 2, [4, 5]))
        assert srv.stats()["availability"] == 1.0

    def test_no_snapshot_at_all_is_terminal(self, tmp_path):
        srv = _server()
        with pytest.raises(ServeError):
            srv.offer_snapshot(str(tmp_path / "empty"))

    def test_swap_window_fault_leaves_old_version_serving(self, tmp_path):
        """Drill point "swap" fires inside the swap window, before the
        commit: the offer dies but the previous version keeps serving."""
        a, b = _phi(seed=4), _phi(seed=5)
        _ckpt(tmp_path, 0, a)
        faults = FaultInjector(plan={"swap": (1,)})
        srv = _server(faults=faults)
        assert srv.offer_snapshot(str(tmp_path))          # occurrence 0
        _ckpt(tmp_path, 1, b)
        with pytest.raises(SimulatedFailure):
            srv.offer_snapshot(str(tmp_path))             # occurrence 1
        assert srv.active_version() == 0
        r = srv.serve([{"u": 6, "candidates": [7]}])[0]
        assert np.array_equal(r.scores, oracle_scores(a, 6, [7]))
        assert r.served_version == 0
        # Retry after the (transient) fault: the swap completes.
        assert srv.offer_snapshot(str(tmp_path))
        assert srv.active_version() == 1

    def test_concurrent_swap_atomicity(self, tmp_path):
        """Queries racing ~30 swaps: every response's scores must match the
        oracle of exactly the version it is stamped with."""
        phis = {v: _phi(seed=100 + v) for v in range(30)}
        _ckpt(tmp_path, 0, phis[0])
        srv = _server(cfg=ServeConfig(batch_slots=4))
        srv.offer_snapshot(str(tmp_path))
        stop = threading.Event()
        errors: list = []

        def swapper():
            try:
                for v in range(1, 30):
                    _ckpt(tmp_path, v, phis[v])
                    assert srv.offer_snapshot(str(tmp_path))
            except Exception as e:               # pragma: no cover
                errors.append(e)
            finally:
                stop.set()

        t = threading.Thread(target=swapper)
        t.start()
        cand = np.array([1, 2, 3, 4, 5])
        qids = []
        while not stop.is_set() or srv.stats()["queue_depth"]:
            qid = srv.submit(9, candidates=cand)
            if qid is not None:
                qids.append(qid)
            srv.tick()
        t.join()
        srv.drain()
        assert not errors
        assert srv.swaps == 30 and len(qids) > 0
        for qid in qids:
            r = srv.responses[qid]
            want = oracle_scores(phis[r.served_version], 9, cand)
            assert np.array_equal(r.scores, want), qid


# ---------------------------------------------------------------------------
# Health-gated swap
# ---------------------------------------------------------------------------


class TestHealthGate:
    def test_nonfinite_candidate_rejected_serves_stale(self, tmp_path):
        phi = _phi(seed=6)
        _ckpt(tmp_path, 0, phi)
        srv = _server()
        srv.offer_snapshot(str(tmp_path))
        bad = phi.copy()
        bad[5, 0] = np.nan
        _ckpt(tmp_path, 1, bad)
        assert not srv.offer_snapshot(str(tmp_path))
        assert srv.rejected_candidates == 1
        assert srv.active_version() == 0
        r = srv.serve([{"u": 1, "candidates": [2]}])[0]
        assert r.freshness == "stale"       # a newer version exists but
        assert r.served_version == 0        # is unhealthy
        assert np.array_equal(r.scores, oracle_scores(phi, 1, [2]))

    def test_good_swap_clears_stale_flag(self, tmp_path):
        phi = _phi(seed=7)
        _ckpt(tmp_path, 0, phi)
        srv = _server()
        srv.offer_snapshot(str(tmp_path))
        bad = np.full_like(phi, np.inf)
        _ckpt(tmp_path, 1, bad)
        assert not srv.offer_snapshot(str(tmp_path))
        assert srv.stats()["freshness"] == "stale"
        _ckpt(tmp_path, 2, _phi(seed=8))
        assert srv.offer_snapshot(str(tmp_path))
        assert srv.stats()["freshness"] == "fresh"

    def test_version_regression_rejected_by_gate(self):
        gate = SnapshotGate(SnapshotGateConfig())
        phi = _phi()
        ok, _ = gate.admit(phi, version=5)
        assert ok
        ok, reason = gate.admit(phi, version=5)
        assert not ok and reason == "version_regression"
        ok, reason = gate.admit(phi, version=6, graph_version=-1)
        assert not ok and reason == "graph_version_regression"

    def test_norm_spike_rejected_after_warmup(self):
        gate = SnapshotGate(SnapshotGateConfig(spike_factor=4.0, warmup_admits=1))
        phi = _phi(seed=9)
        assert gate.admit(phi, version=0)[0]
        ok, reason = gate.admit(phi * 100.0, version=1)
        assert not ok and reason == "norm_spike"
        assert gate.admit(phi * 1.01, version=2)[0]

    def test_rejected_first_candidate_is_terminal(self, tmp_path):
        bad = np.full((8, 4), np.nan, np.float32)
        _ckpt(tmp_path, 0, bad)
        srv = _server()
        with pytest.raises(ServeError, match="rejected"):
            srv.offer_snapshot(str(tmp_path))


# ---------------------------------------------------------------------------
# Degrade ladder + admission control
# ---------------------------------------------------------------------------


class TestDegradeLadderAndAdmission:
    def test_refresh_state_moves_the_ladder(self, tmp_path):
        phi = _phi(seed=10)
        _ckpt(tmp_path, 0, phi)
        srv = _server()
        srv.offer_snapshot(str(tmp_path))
        srv.note_refresh("degraded")
        r = srv.serve([{"u": 1, "candidates": [2]}])[0]
        assert r.freshness == "stale"
        srv.note_refresh("ok")
        r = srv.serve([{"u": 1, "candidates": [2]}])[0]
        assert r.freshness == "fresh"
        with pytest.raises(AssertionError):
            srv.note_refresh("on_fire")

    def test_no_version_sheds_at_admission(self):
        srv = _server()
        assert srv.submit(1, candidates=[2]) is None
        assert srv.shed == {"no_version": 1}

    def test_queue_overflow_sheds(self, tmp_path):
        _ckpt(tmp_path, 0, _phi())
        srv = _server(cfg=ServeConfig(batch_slots=4, max_queue=3))
        srv.offer_snapshot(str(tmp_path))
        qids = [srv.submit(1, candidates=[2]) for _ in range(5)]
        assert sum(q is not None for q in qids) == 3
        assert srv.shed["overflow"] == 2
        srv.drain()
        assert srv.stats()["availability"] == 1.0   # of admitted

    def test_queue_overflow_drill(self, tmp_path):
        _ckpt(tmp_path, 0, _phi())
        faults = FaultInjector(inject_plan={"queue_overflow": (1,)})
        srv = _server(faults=faults)
        srv.offer_snapshot(str(tmp_path))
        assert srv.submit(1, candidates=[2]) is not None
        assert srv.submit(1, candidates=[2]) is None   # drilled occurrence
        assert srv.submit(1, candidates=[2]) is not None
        assert srv.shed["overflow"] == 1

    def test_deadline_shed_uses_wave_ema_prediction(self, tmp_path):
        """After a slow wave (fake clock), a tight deadline is shed at
        admission while a loose one is admitted."""
        clock = FakeClock()
        _ckpt(tmp_path, 0, _phi(seed=11))
        srv = _server(cfg=ServeConfig(batch_slots=4, headroom=1.0), clock=clock)
        srv.offer_snapshot(str(tmp_path))
        # The first wave is never shed (no EMA yet); the fake clock charges
        # it 1 s of wall, seeding the predictor.
        assert srv.submit(1, candidates=[2], deadline_s=0.1) is not None
        inner = srv._score_wave

        def slow(wave, snap):
            clock.advance(1.0)
            return inner(wave, snap)

        srv._score_wave = slow
        srv.drain()
        assert srv._wave_ema == pytest.approx(1.0)
        # predicted = 1 wave * 1 s EMA * 1.0 headroom = 1 s.
        assert srv.submit(2, candidates=[3], deadline_s=0.1) is None
        assert srv.shed["deadline"] == 1
        assert srv.submit(2, candidates=[3], deadline_s=10.0) is not None
        srv.drain()
        assert srv.stats()["availability"] == 1.0

    def test_wave_fault_requeues_admitted_queries(self, tmp_path):
        """The "serve_wave" drill kills a wave mid-flight: the wave goes
        back to the queue front and the retry answers every query."""
        phi = _phi(seed=12)
        _ckpt(tmp_path, 0, phi)
        faults = FaultInjector(plan={"serve_wave": (0,)})
        srv = _server(faults=faults)
        srv.offer_snapshot(str(tmp_path))
        qids = [srv.submit(u, candidates=[1, 2]) for u in (3, 4, 5)]
        with pytest.raises(SimulatedFailure):
            srv.tick()
        assert srv.wave_faults == 1
        assert srv.stats()["queue_depth"] == 3       # nothing dropped
        srv.drain()
        for qid, u in zip(qids, (3, 4, 5)):
            assert np.array_equal(srv.responses[qid].scores, oracle_scores(phi, u, [1, 2]))
        assert srv.stats()["availability"] == 1.0

    def test_stats_shape(self, tmp_path):
        _ckpt(tmp_path, 0, _phi())
        srv = _server()
        srv.offer_snapshot(str(tmp_path))
        srv.serve([{"u": 1, "candidates": [2]}, {"u": 3, "k": 2}])
        s = srv.stats()
        assert s["served"] == 2 and s["availability"] == 1.0
        assert s["served_by_version"] == {0: 2}
        assert s["served_by_freshness"]["fresh"] == 2
        assert s["latency_p50_s"] >= 0.0
        assert s["offered_total"] == s["admitted"] + s["shed_total"]


# ---------------------------------------------------------------------------
# The scoring's plain versions against the reference and the oracle
# ---------------------------------------------------------------------------

#: Every d the kernel must take: below, at and above a float4 step, a
#: staged 128-column chunk and its ragged successor.
KERNEL_DIMS = (1, 7, 16, 17, 64, 128, 129)


def _hard_phi(n, d, seed, subnormal=False, zeros=True):
    """Random rows, three duplicated rows (tied scores), with ``zeros`` two
    zero rows (scores of +0.0 and -0.0), and with ``subnormal`` a few rows
    whose products and sums are subnormal."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((n, d)).astype(np.float32)
    phi[5] = phi[3]
    phi[9] = phi[3]
    phi[n - 1] = phi[3]
    if zeros:
        phi[2] = 0.0
        phi[7] = -0.0
    phi[11, :] = -phi[12, :]
    if subnormal:
        phi[13] = np.float32(1e-20) * rng.standard_normal(d).astype(np.float32)
        phi[14] = np.float32(3e-19) * rng.standard_normal(d).astype(np.float32)
    return phi


def _cand(rng, n, b, width):
    return rng.integers(0, n, size=(b, width))


@pytest.mark.parametrize("d", KERNEL_DIMS)
def test_plain_scores_equal_reference_scoring(d):
    """``pair_scores_ref`` / ``all_scores_ref`` + ``topk_from_scores``
    against the reference's jitted ``_score_candidates`` / ``_topk``, bit
    for bit, at batches 1, 5 and 40, widths up to 64 and k 1, 10 and N.
    No subnormals here: XLA on the CPU flushes them to zero (the NumPy
    oracle keeps them, as the port does; the next test). Top-K without the
    zero rows: ``lax.top_k`` ranks +0.0 ahead of -0.0, where the oracle
    holds them tied (the signed-zero test below)."""
    import jax.numpy as jnp
    from repro.runtime import serve as ref_serve

    n = 97
    phi = _hard_phi(n, d, seed=d)
    nonzero = _hard_phi(n, d, seed=d, zeros=False)
    rng = np.random.default_rng(d + 1)
    t_phi, t_nonzero = torch.from_numpy(phi), torch.from_numpy(nonzero)
    for b in (1, 5, 40):
        u = rng.integers(0, n, size=b)
        u[0] = 3                           # a duplicated row: tied with 5, 9 and n - 1
        for width in (1, 3, 64):
            cand = _cand(rng, n, b, width)
            want = np.asarray(ref_serve._score_candidates(
                jnp.asarray(phi), jnp.asarray(u, jnp.int32), jnp.asarray(cand, jnp.int32)))
            got = chain_ref.pair_scores_ref(t_phi, torch.from_numpy(u),
                                            torch.from_numpy(cand)).numpy()
            assert got.dtype == want.dtype and np.array_equal(got.view(np.uint32),
                                                              want.view(np.uint32)), (b, width)
        for k in (1, 10, n):
            wv, wi = ref_serve._topk(jnp.asarray(nonzero), jnp.asarray(u, jnp.int32), k)
            gv, gi = chain_ref.topk_from_scores(
                chain_ref.all_scores_ref(t_nonzero, torch.from_numpy(u)), torch.from_numpy(u),
                k)
            wv, wi = np.asarray(wv), np.asarray(wi)
            assert gi.numpy().dtype == wi.dtype == np.int32
            assert np.array_equal(gi.numpy(), wi), (b, k)
            assert np.array_equal(gv.numpy().view(np.uint32), wv.view(np.uint32)), (b, k)


@pytest.mark.parametrize("d", KERNEL_DIMS)
def test_plain_scores_equal_numpy_oracle_with_subnormals(d):
    """The plain versions against ``oracle_scores`` / ``oracle_topk``, bit
    for bit (signs of zero included), on a phi with ties, zero rows and
    subnormal products, at every candidate width up to 1,024 in powers of
    two and their ragged neighbours."""
    n = 1100
    phi = _hard_phi(n, d, seed=100 + d, subnormal=True)
    t_phi = torch.from_numpy(phi)
    rng = np.random.default_rng(d)
    queries = np.array([3, 2, 7, 11, 13, 14, 0])
    for width in (1, 2, 3, 31, 32, 33, 511, 1024):
        cand = _cand(rng, n, len(queries), width)
        cand[:, 0] = 5
        got = chain_ref.pair_scores_ref(t_phi, torch.from_numpy(queries),
                                        torch.from_numpy(cand)).numpy()
        for i, u in enumerate(queries):
            want = oracle_scores(phi, u, cand[i])
            assert np.array_equal(got[i].view(np.uint32), want.view(np.uint32)), (width, u)
    scores = chain_ref.all_scores_ref(t_phi, torch.from_numpy(queries))
    for k in (1, 10, 100, n):
        vals, ids = chain_ref.topk_from_scores(scores, torch.from_numpy(queries), k)
        for i, u in enumerate(queries):
            wv, wi = oracle_topk(phi, u, k)
            assert np.array_equal(ids[i].numpy(), wi), (k, u)
            assert np.array_equal(vals[i].numpy().view(np.uint32), wv.view(np.uint32)), (k, u)
    assert (scores[1] == 0).all() and (scores[:, 2] == 0).all()      # the zero rows


def test_ties_and_signed_zeros_against_oracle_and_reference(tmp_path):
    """Served top-K and pair scores on a phi of tied rows and zero rows,
    whose scores hold both +0.0 and -0.0. The port's server gives the
    NumPy oracle's ids (ties toward the lower id, -0.0 tied with +0.0) and
    bits. The reference's server gives the same bits in its own order:
    ``lax.top_k`` ranks every +0.0 ahead of every -0.0, so its ids are the
    oracle's full ranking with each run of zero scores reordered so."""
    from repro.ckpt.checkpoint import save_checkpoint as ref_save
    from repro.runtime import serve as ref_serve

    d, n = 16, 40
    phi = _hard_phi(n, d, seed=3)
    phi[20] = np.float32(0)
    phi[20, 0] = 1.0                        # one nonzero column: products of +-0.0
    phi[21] = -phi[20]
    ref_save(str(tmp_path), 0, {"phi_in": phi}, meta={"graph_version": 0, "global_step": 0})
    specs = [{"u": u, "k": k} for u in (3, 2, 7, 20, 21) for k in (1, 10, n)] + \
        [{"u": 20, "candidates": [2, 7, 21, 2, 20, 0]}]
    port = _server(cfg=ServeConfig(batch_slots=32))
    ref = ref_serve.EmbedServer(ref_serve.ServeConfig(batch_slots=32))
    for srv in (port, ref):
        assert srv.offer_snapshot(str(tmp_path))
    got, want = port.serve(specs), ref.serve(specs)
    signs, reordered = set(), 0
    for spec, g, w in zip(specs, got, want):
        if "candidates" in spec:
            ov = oracle_scores(phi, spec["u"], spec["candidates"])
            assert np.array_equal(g.ids, spec["candidates"]) and np.array_equal(w.ids, g.ids)
            assert np.array_equal(g.scores.view(np.uint32), ov.view(np.uint32)), spec
            assert np.array_equal(w.scores.view(np.uint32), ov.view(np.uint32)), spec
            continue
        ov, oi = oracle_topk(phi, spec["u"], spec["k"])
        assert np.array_equal(g.ids, oi), spec
        assert np.array_equal(g.scores.view(np.uint32), ov.view(np.uint32)), spec
        fv, fi = oracle_topk(phi, spec["u"], n)
        ref_order = np.lexsort((np.arange(n), np.signbit(fv) & (fv == 0), -fv))[:spec["k"]]
        assert np.array_equal(w.ids, fi[ref_order]), spec
        assert np.array_equal(w.scores.view(np.uint32), fv[ref_order].view(np.uint32)), spec
        reordered += not np.array_equal(w.ids, oi)
        signs |= {bool(np.signbit(x)) for x in g.scores[g.scores == 0]}
    assert signs == {True, False}            # both zeros were served
    assert reordered > 0                     # and the reference ranked them apart


# ---------------------------------------------------------------------------
# One scripted lifecycle through both packages' servers
# ---------------------------------------------------------------------------


def _scripted_lifecycle(tmp_path, serve_mod, faults_mod, make_server):
    """The same checkpoints and queries, under a fake clock, through one
    package's server: returns every response and the stats."""
    clock = FakeClock()
    faults = faults_mod.FaultInjector(plan={"swap": (3,), "serve_wave": (3,)},
                                      inject_plan={"queue_overflow": (4,)})
    srv = make_server(serve_mod.ServeConfig(batch_slots=4, max_queue=6, headroom=1.0),
                      faults, clock)
    inner = srv._score_wave

    def timed(wave, snap):                  # every wave takes 0.25 s of the fake clock
        clock.advance(0.25)
        return inner(wave, snap)

    srv._score_wave = timed
    root = str(tmp_path / "ckpt")
    out = []

    def step(queries):
        for q in queries:
            out.append(("qid", srv.submit(q["u"], q.get("candidates"), k=q.get("k"),
                                          deadline_s=q.get("deadline_s"))))
            clock.advance(0.01)
        while True:
            try:
                if not srv.tick():
                    break
            except faults_mod.SimulatedFailure:
                out.append(("wave_fault", srv.stats()["queue_depth"]))

    qs = lambda u0: [{"u": u0, "candidates": [1, 2, 3]}, {"u": u0 + 1, "k": 5},
                     {"u": u0 + 2, "candidates": list(range(10, 19))}, {"u": u0 + 3, "k": 64},
                     {"u": u0 + 4, "candidates": []}]
    _ckpt(root, 0, _phi(seed=21))
    out.append(("offer", srv.offer_snapshot(root)))
    step(qs(0))
    # Torn newer step: invisible; the loader falls back to the active one.
    torn = tmp_path / "ckpt" / "step_00000005"
    torn.mkdir()
    (torn / "phi_in.npy").write_bytes(b"\x93NUMPY garbage")
    out.append(("offer", srv.offer_snapshot(root)))
    # Two replicas, averaged on the host.
    _ckpt(root, 1, np.stack([_phi(seed=22), _phi(seed=23)]), graph_version=1)
    out.append(("offer", srv.offer_snapshot(root)))
    step(qs(10))
    # A rejected candidate (non-finite): stale until the next good swap.
    bad = _phi(seed=24)
    bad[3, 3] = np.nan
    _ckpt(root, 2, bad, graph_version=2)
    out.append(("offer", srv.offer_snapshot(root)))
    srv.note_refresh("degraded")
    step(qs(20))
    # The swap drill (occurrence 2): the offer dies inside the window.
    _ckpt(root, 3, _phi(seed=25), graph_version=3)
    try:
        srv.offer_snapshot(root)
    except faults_mod.SimulatedFailure:
        out.append(("swap_fault", srv.active_version()))
    out.append(("offer", srv.offer_snapshot(root)))
    srv.note_refresh("ok")
    # Overflow (a full queue, then the drill) and deadline sheds.
    step(qs(30) + qs(40)[:3] + [{"u": 50, "candidates": [1], "deadline_s": 0.1},
                               {"u": 51, "k": 3, "deadline_s": 100.0}])
    step([{"u": 52, "candidates": [5, 6], "deadline_s": 0.1},
          {"u": 53, "candidates": [5, 6], "deadline_s": 10.0}])
    return out, srv.responses, srv.stats()


def test_scripted_lifecycle_equals_reference(tmp_path):
    """A torn step, a replica mean, a rejected candidate, the ``swap`` and
    ``serve_wave`` drills, overflow (real and drilled) and deadline sheds,
    under one fake clock: every response field (ids and scores bit for bit,
    with their dtypes) and ``stats()`` equal the reference server's."""
    from repro.runtime import faults as ref_faults
    from repro.runtime import serve as ref_serve
    from repro_torch.runtime import faults as port_faults
    from repro_torch.runtime import serve as port_serve

    got = _scripted_lifecycle(tmp_path / "port", port_serve, port_faults,
                              lambda cfg, f, c: port_serve.EmbedServer(cfg, faults=f, clock=c,
                                                                       device="cpu"))
    want = _scripted_lifecycle(tmp_path / "ref", ref_serve, ref_faults,
                               lambda cfg, f, c: ref_serve.EmbedServer(cfg, faults=f, clock=c))
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for qid, w in want[1].items():
        g = got[1][qid]
        for field in ("qid", "u", "served_version", "served_graph_version", "staleness_s",
                      "freshness", "latency_s"):
            assert getattr(g, field) == getattr(w, field), (qid, field)
        for field in ("ids", "scores"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, (qid, field)
            assert a.tobytes() == b.tobytes(), (qid, field)
    assert got[2] == want[2]
    s = got[2]
    assert s["shed"]["overflow"] >= 2 and s["shed"]["deadline"] >= 1
    assert s["wave_faults"] == 1 and s["rejected_candidates"] == 1
    assert s["availability"] == 1.0 and set(s["served_by_version"]) == {0, 1, 3}


# ---------------------------------------------------------------------------
# benchmarks/serve.py's lifecycle on the port
# ---------------------------------------------------------------------------


def test_serve_benchmark_lifecycle_on_the_port():
    """``benchmarks/serve.py`` at its quick size (rmat 512, dim 32, 64
    queries a churn round) on the port's pipeline, ingest driver and
    server, in two churn rounds where the benchmark runs four (a refresh
    takes ~17 s on one CPU thread): the fault plan moves up so that the
    first drain is the retry storm (two failed attempts, then success) and
    the second the refresh death (every attempt fails; the operator's
    drain absorbs it), with the torn candidate and the swap drill on the
    server's third offer. Every response equals the oracle of the version it is stamped
    with, each top-K is the oracle's, availability is 1.0, and the
    responses served between the refresh death and its recovery are
    stamped stale."""
    import dataclasses
    import os
    import tempfile

    from repro_torch.core.api import EmbedConfig, make_walk_plan
    from repro_torch.core.dsgl import DSGLConfig
    from repro_torch.graph.generators import churn_batch, rmat_graph
    from repro_torch.runtime.ingest import IngestConfig, IngestDriver
    from repro_torch.runtime.trainer import StreamingEmbedPipeline

    n, dim, churn_rounds, per_round = 512, 32, 2, 64
    g = rmat_graph(n, 10, seed=3, device="cpu")
    cfg = dataclasses.replace(EmbedConfig(dim=dim, epochs=1, lr=0.05, delta=1e-3, max_len=40,
                                          min_len=10, window=6, negatives=4, seed=3),
                              rng_mode="vertex")
    policy, spec, rounds = make_walk_plan(cfg)
    pipe = StreamingEmbedPipeline(g, policy, spec, rounds,
                                  DSGLConfig(dim=dim, epochs=1, lr=0.05, window=6, negatives=4,
                                             seed=3))
    pipe.run()
    rng = np.random.default_rng(11)
    with tempfile.TemporaryDirectory() as root:
        ingest_faults = FaultInjector(plan={"refresh": (0, 1, 3, 4, 5, 6)})
        serve_faults = FaultInjector(plan={"swap": (2,)})
        srv = EmbedServer(ServeConfig(batch_slots=32), faults=serve_faults, device="cpu")
        drv = IngestDriver(os.path.join(root, "ing"), pipe,
                           cfg=IngestConfig(apply_every=1, max_retries=3, backoff_s=0.0),
                           faults=ingest_faults, server=srv)
        torn = os.path.join(drv.ckpt_dir, "step_00000099")
        os.makedirs(torn)
        with open(os.path.join(torn, "phi_in.npy"), "wb") as f:
            f.write(b"\x93NUMPY torn candidate")
        phis = {srv.active_version(): srv.active_phi()}
        qids, topk_qids, stale_qids = [], set(), []
        refresh_deaths = 0
        for r in range(churn_rounds):
            try:
                drv.submit(churn_batch(drv.pipeline.graph, frac=0.02, seed=100 + r))
            except Exception:
                refresh_deaths += 1
                for _ in range(per_round // 4):
                    qid = srv.submit(int(rng.integers(0, n)), k=8)
                    if qid is not None:
                        topk_qids.add(qid)
                        qids.append(qid)
                        stale_qids.append(qid)
                srv.drain()
                drv.drain()
            v = srv.active_version()
            if v not in phis:
                phis[v] = srv.active_phi()
            for _ in range(per_round):
                u = int(rng.integers(0, n))
                if rng.random() < 0.5:
                    qid = srv.submit(u, candidates=rng.integers(0, n,
                                                                size=int(rng.integers(1, 9))))
                else:
                    qid = srv.submit(u, k=8)
                    if qid is not None:
                        topk_qids.add(qid)
                if qid is not None:
                    qids.append(qid)
                if len(qids) % 16 == 0:
                    srv.tick()
            srv.drain()
        stats = srv.stats()
    assert refresh_deaths == 1 and drv.retries == 2 + 3
    assert serve_faults.fired == [("swap", 2)] and stats["swaps"] == 2
    assert stats["availability"] == 1.0 and stats["served"] == len(qids)
    assert stale_qids and all(srv.responses[q].freshness == "stale" for q in stale_qids)
    for qid in qids:
        resp = srv.responses[qid]
        phi = phis[resp.served_version]
        assert np.array_equal(resp.scores, oracle_scores(phi, resp.u, resp.ids)), qid
    for qid in sorted(topk_qids)[:128]:
        resp = srv.responses[qid]
        vals, ids = oracle_topk(phis[resp.served_version], resp.u, 8)
        assert np.array_equal(resp.ids, ids) and np.array_equal(resp.scores, vals), qid


# ---------------------------------------------------------------------------
# Nothing falls back
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_cpu_tensors():
    phi = torch.from_numpy(_phi())
    u = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="card only"):
        chain_ops.all_scores(phi, u)
    with pytest.raises(ValueError, match="card only"):
        chain_ops.pair_scores(phi, u, torch.tensor([[3], [4]]))
    assert chain_ops.LAUNCHES == 0


def test_server_on_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbedServer()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", KERNEL_DIMS)
def test_kernel_equals_plain_versions_on_the_card(cuda_device, d):
    """``all_scores`` and ``pair_scores`` on the card against ``ref.py`` on
    the card, bit for bit, at batches 1, 5, 32 and 40 and widths 1-1,024,
    on a phi with ties, zero rows and subnormals; one launch a call."""
    n = 3000
    phi = torch.from_numpy(_hard_phi(n, d, seed=d, subnormal=True)).to(cuda_device)
    rng = np.random.default_rng(d)
    for b in (1, 5, 32, 40):
        u = torch.from_numpy(rng.integers(0, n, size=b)).to(cuda_device)
        before = chain_ops.LAUNCHES
        got = chain_ops.all_scores(phi, u)
        assert chain_ops.LAUNCHES == before + 1
        want = chain_ref.all_scores_ref(phi, u)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), b
        for width in (1, 3, 64, 1000, 1024):
            cand = torch.from_numpy(rng.integers(0, n, size=(b, width))).to(cuda_device)
            got = chain_ops.pair_scores(phi, u, cand)
            want = chain_ref.pair_scores_ref(phi, u, cand)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (b, width)
