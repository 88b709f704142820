"""Telemetry of the port (``repro_torch.obs``) against the JAX package's.

The substrate's behaviours (``tests/test_obs.py``'s, on the port): the
metrics registry, the span tracer and its contextvar isolation, the
structured logger, the flight recorder (a dump per fired fault, and on a
``refresh_splice`` crash one whose open span carries the round and the
graph version), and the run-telemetry document, which either package's
loader reads. On one fixed-mode run (DeepWalk, ``info_mode="fixed"``:
walks bit-exact across the packages) the port reports the counters, gauges
and histograms the reference reports, under the same names and, but for the
floats of training, with the same values. Telemetry on and off give
bit-equal phi and rings: a plain run, a run healed by the watchdog and a
crashed and resumed run.
"""

import json
import logging
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.common import logging as plog
from repro_torch.common.logging import get_logger, log_context, refresh_log_level
from repro_torch.core.api import EmbedConfig, make_walk_plan
from repro_torch.core.dsgl import DSGLConfig
from repro_torch.graph.generators import rmat_graph
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.runtime.faults import FaultInjector, SimulatedFailure, run_with_restarts
from repro_torch.runtime.health import HealthConfig, HealthMonitor
from repro_torch.runtime.trainer import StreamingEmbedPipeline

# Small CPU tensors, and several test workers share the cores.
torch.set_num_threads(1)

#: A fixed-mode DeepWalk plan (bit-exact walks in both packages), short walks.
PLAN = dict(method="deepwalk", info_termination=False, fixed_len=20, fixed_rounds=4, dim=16,
            seed=3, rng_mode="vertex")
DSGL = dict(dim=16, seed=3, batch_groups=16)


def _plan():
    policy, spec, rounds = make_walk_plan(EmbedConfig(**PLAN))
    return policy, spec, rounds, DSGLConfig(**DSGL)


def _pipeline(graph, **kw):
    policy, spec, rounds, dsgl = _plan()
    return StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl, **kw)


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(128, 7, seed=7, device="cpu")


@pytest.fixture(autouse=True)
def _clean_registry():
    obs.reset()
    obs.configure(enabled=True, clear_sinks=True)
    yield
    obs.reset()
    obs.configure(enabled=True, clear_sinks=True)


# --- metrics registry -------------------------------------------------------


class TestMetrics:
    def test_counter_gauge(self):
        obs.inc("x.count")
        obs.inc("x.count", 2.5)
        obs.set_gauge("x.g", 7)
        snap = obs.REGISTRY.snapshot()
        assert snap["counters"]["x.count"] == 3.5
        assert snap["gauges"]["x.g"] == 7.0

    def test_histogram_window_is_bounded(self):
        h = obs.REGISTRY.histogram("x.h", window=8)
        for v in range(100):
            h.observe(v)
        assert len(h.values()) == 8
        assert h.count == 100                      # the lifetime count survives
        assert h.min == 0 and h.max == 99
        assert h.percentile(50) == pytest.approx(np.percentile(np.arange(92, 100), 50))

    def test_empty_histogram(self):
        h = obs_metrics.Histogram("empty")
        assert h.percentile(50) is None
        assert h.summary() == {"count": 0}

    def test_disabled_is_noop(self):
        with obs.override(enabled=False):
            obs.inc("gone")
            obs.set_gauge("gone.g", 1)
            obs.observe("gone.h", 1.0)
        snap = obs.REGISTRY.snapshot()
        assert "gone" not in snap["counters"]
        assert "gone.g" not in snap["gauges"]
        assert "gone.h" not in snap["histograms"]

    def test_prometheus_snapshot_matches_reference(self):
        """The exposition text is the reference's, character for character."""
        from repro import obs as ref_obs

        ref_obs.reset()
        try:
            for o in (obs, ref_obs):
                o.inc("walk.supersteps", 41)
                o.set_gauge("walk.pool_slots", 256)
                o.observe("span.walk.round.s", 0.25)
            text = obs.prometheus_snapshot()
            assert "# TYPE repro_walk_supersteps counter" in text
            assert 'repro_span_walk_round_s{quantile="0.50"} 0.25' in text
            assert text == ref_obs.prometheus_snapshot()
        finally:
            ref_obs.reset()

    def test_attach_shares_owned_histogram(self):
        h = obs_metrics.Histogram(window=4)
        obs.REGISTRY.attach("x.latency_s", h)
        h.observe(1.0)
        assert obs.REGISTRY.snapshot()["histograms"]["x.latency_s"]["count"] == 1


# --- span tracer ------------------------------------------------------------


class TestTracer:
    def test_nesting_and_recorder_order(self):
        with obs.trace_span("outer", round=1) as f_out:
            with obs.trace_span("inner", shard=2) as f_in:
                assert f_in["parent"] == "outer" and f_in["depth"] == 1
                assert obs.ambient_fields() == {"round": 1, "shard": 2}
            assert obs.current_span() is f_out
        assert obs.current_span() is None
        assert [r["name"] for r in obs.recent()] == ["inner", "outer"]   # inner closes first
        snap = obs.REGISTRY.snapshot()
        assert snap["histograms"]["span.outer.s"]["count"] == 1
        assert snap["histograms"]["span.inner.s"]["count"] == 1

    def test_span_error_marked_and_propagated(self):
        with pytest.raises(ValueError):
            with obs.trace_span("boom"):
                raise ValueError("x")
        rec = obs.recent()[-1]
        assert rec["ok"] is False and rec["error"] == "ValueError"

    def test_span_event_inherits_ambient_fields(self):
        with log_context(shard=3):
            with obs.trace_span("walk.round", round=7):
                obs.span_event("fault.fire", point="superstep")
        ev = [r for r in obs.recent() if r["kind"] == "event"][0]
        assert ev["fields"] == {"shard": 3, "round": 7, "point": "superstep"}
        assert ev["span"] == "walk.round"

    def test_disabled_span_is_passthrough(self):
        with obs.override(enabled=False):
            with obs.trace_span("off", round=1) as f:
                assert f is None and obs.current_span() is None
        assert obs.recent() == []

    def test_prefetch_thread_contextvar_isolation(self):
        """A span opened on the driver thread is invisible to the prefetch
        thread (``data.pipeline.Prefetcher``, which ``DSGLTrainer`` runs)."""
        from repro_torch.data.pipeline import Prefetcher

        seen = []
        started = threading.Event()

        def fetch(step):
            with obs.trace_span("thread.fetch", step=step):
                seen.append(tuple(f["name"] for f in obs.span_stack()))
            started.set()
            return step

        with obs.trace_span("driver.loop", round=0):
            pf = Prefetcher(fetch, depth=1)
            try:
                pf.next()
                started.wait(5.0)
            finally:
                pf.close()
            assert [f["name"] for f in obs.span_stack()] == ["driver.loop"]
        assert seen and all(names == ("thread.fetch",) for names in seen)

    def test_span_jsonl_stream(self, tmp_path):
        path = str(tmp_path / "events.jsonl")
        with obs.override(jsonl_path=path):
            with obs.trace_span("walk.round", round=4):
                obs.span_event("tick")
        lines = [json.loads(s) for s in open(path).read().splitlines()]
        assert [r["kind"] for r in lines] == ["event", "span"]
        assert lines[1]["name"] == "walk.round" and lines[1]["fields"]["round"] == 4


# --- structured logging -----------------------------------------------------


class TestLogging:
    def test_handler_install_is_idempotent(self):
        root = logging.getLogger(plog.ROOT_LOGGER)
        get_logger()
        n = len(root.handlers)
        for _ in range(5):
            get_logger("repro_torch.sub")
        assert len(root.handlers) == n

    @pytest.mark.parametrize("raw,level", [("DEBUG", logging.DEBUG), ("41", 41),
                                           ("bogus", logging.INFO), (None, logging.INFO)])
    def test_env_level_parsing(self, monkeypatch, raw, level):
        if raw is None:
            monkeypatch.delenv("REPRO_LOG_LEVEL", raising=False)
        else:
            monkeypatch.setenv("REPRO_LOG_LEVEL", raw)
        assert plog._env_level() == level

    def test_level_reread_from_env(self, monkeypatch):
        root = logging.getLogger(plog.ROOT_LOGGER)
        monkeypatch.setenv("REPRO_LOG_LEVEL", "DEBUG")
        assert refresh_log_level() == logging.DEBUG and root.level == logging.DEBUG
        monkeypatch.setenv("REPRO_LOG_LEVEL", "WARNING")
        get_logger()                  # get_logger re-reads the variable too
        assert root.level == logging.WARNING
        monkeypatch.delenv("REPRO_LOG_LEVEL")
        refresh_log_level()

    def test_log_context_fields_nest_and_restore(self):
        import io

        lg = get_logger("repro_torch.test.ctx")
        handler = [h for h in logging.getLogger(plog.ROOT_LOGGER).handlers
                   if getattr(h, plog._HANDLER_TAG, False)][0]
        buf = io.StringIO()
        old = handler.setStream(buf)
        try:
            with log_context(round=4, shard=1):
                with log_context(graph_version=2):
                    lg.warning("deep")
                lg.warning("inside")
            lg.warning("outside")
        finally:
            handler.setStream(old)
        lines = buf.getvalue().splitlines()
        line = lambda word: [ln for ln in lines if word in ln][0]
        assert "round=4 shard=1 graph_version=2" in line("deep")
        assert "round=4 shard=1]" in line("inside")
        assert "round=" not in line("outside")

    def test_span_close_logs_through_shared_formatter(self, monkeypatch):
        monkeypatch.setenv("REPRO_LOG_LEVEL", "DEBUG")
        refresh_log_level()
        records = []

        class Capture(logging.Handler):
            def emit(self, record):
                records.append(record)

        h = Capture(level=logging.DEBUG)
        root = logging.getLogger(plog.ROOT_LOGGER)
        root.addHandler(h)
        try:
            with obs.trace_span("walk.round", round=9):
                pass
        finally:
            root.removeHandler(h)
            monkeypatch.delenv("REPRO_LOG_LEVEL")
            refresh_log_level()
        assert any("span walk.round" in r.getMessage() for r in records)


# --- flight recorder --------------------------------------------------------


def _supervised(graph, root, faults, health=None):
    """Run under ``run_with_restarts``: crash -> resume from the newest
    snapshot (or start over) -> continue. Returns the last pipeline."""
    policy, spec, rounds, dsgl = _plan()
    state = {"p": StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl, health=health)}

    def attempt(i):
        return state["p"].run(ckpt_root=root, ckpt_every_rounds=1, faults=faults)

    def recover(i):
        try:
            state["p"] = StreamingEmbedPipeline.resume(root, policy, spec, dsgl,
                                                       health=health, device="cpu")
        except FileNotFoundError:
            state["p"] = StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl,
                                                health=health)

    run_with_restarts(attempt, recover=recover)
    return state["p"]


class TestFlightRecorder:
    def test_ring_is_bounded(self):
        obs_recorder.resize(16)
        try:
            for i in range(100):
                obs.span_event("e", i=i)
            recs = obs.recent()
            assert len(recs) == 16 and recs[-1]["fields"]["i"] == 99
        finally:
            obs_recorder.resize(obs_recorder.DEFAULT_RING)

    def test_no_dump_without_flight_dir(self):
        assert obs.dump_flight_record("nope") is None

    def test_dump_on_refresh_splice_fault(self, graph, tmp_path):
        """A ``refresh_splice`` crash dumps a record whose faulting span
        carries the round and the graph version, and the shard of the
        enclosing ``log_context``."""
        from repro_torch.core.incremental import IncrementalRefresh
        from repro_torch.graph.generators import churn_batch

        flight = tmp_path / "flight"
        p = _pipeline(graph)
        p.run()
        refresher = IncrementalRefresh(p).apply_updates(churn_batch(graph, 0.05, seed=11))
        with obs.override(flight_dir=str(flight)):
            with log_context(shard=0), pytest.raises(SimulatedFailure):
                refresher.refresh(faults=FaultInjector({"refresh_splice": [0]}))
        dumps = sorted(flight.glob("flight_fault_refresh_splice_*.json"))
        assert len(dumps) == 1
        doc = obs.load_flight_record(str(dumps[0]))
        assert doc["schema"] == "repro.flight_record.v1"
        ctx = doc["context"]
        assert ctx["point"] == "refresh_splice" and ctx["shard"] == 0
        assert "round" in ctx and "graph_version" in ctx
        spans = {s["name"]: s for s in doc["open_spans"]}
        assert set(spans["refresh.splice"]["fields"]) >= {"round", "graph_version"}
        assert doc["metrics"]["counters"]["faults.fired.refresh_splice"] == 1
        assert any(r["name"] == "refresh.enter" for r in doc["ring"])

    def test_one_dump_per_fired_fault(self, graph, tmp_path):
        flight = tmp_path / "flight"
        faults = FaultInjector({"round": [1], "superstep": [4]}, torn_plan={"ckpt": [2]})
        with obs.override(flight_dir=str(flight)):
            _supervised(graph, str(tmp_path / "ckpt"), faults)
        dumps = sorted(p.name for p in flight.glob("flight_*.json"))
        assert len(faults.fired) == 2 and len(dumps) == len(faults.fired), dumps
        assert {d.split("_")[2] for d in dumps} == {"round", "superstep"}
        counters = obs.REGISTRY.snapshot()["counters"]
        assert counters["supervisor.restarts"] == 3          # two fired faults, one torn write
        assert counters["faults.torn.ckpt"] == 1 and counters["ckpt.resumes"] == 3

    def test_supervisor_restart_events_and_exhaustion_dump(self, tmp_path):
        calls = []

        def attempt(i):
            calls.append(i)
            if i < 2:
                raise SimulatedFailure("boom")
            return "ok"

        assert run_with_restarts(attempt) == ("ok", 2)
        assert obs.REGISTRY.snapshot()["counters"]["supervisor.restarts"] == 2
        assert len([r for r in obs.recent() if r["name"] == "supervisor.restart"]) == 2

        def always(i):
            raise SimulatedFailure("again")

        with obs.override(flight_dir=str(tmp_path)), pytest.raises(SimulatedFailure):
            run_with_restarts(always, max_restarts=1)
        assert len(list(tmp_path.glob("flight_restarts_exhausted_*.json"))) == 1


# --- RUN_TELEMETRY.json -----------------------------------------------------


class TestRunTelemetry:
    def test_round_trip_through_both_loaders(self, graph, tmp_path):
        """A pipeline run's document round-trips, and the reference's loader
        accepts it (one schema for both packages)."""
        from repro.obs import load_run_telemetry as ref_load

        _pipeline(graph).run()
        path = str(tmp_path / "RUN_TELEMETRY.json")
        doc = obs.write_run_telemetry(path, run={"bench": "unit", "nodes": 128})
        loaded = obs.load_run_telemetry(path)
        assert loaded == json.loads(json.dumps(doc)) == ref_load(path)
        assert loaded["schema"] == "repro.run_telemetry.v1"
        assert loaded["run"]["nodes"] == 128
        assert loaded["counters"]["train.steps"] == 16
        assert loaded["gauges"]["walk.rounds"] == 4
        assert loaded["histograms"]["span.walk.round.s"]["count"] == 4

    def test_schema_validation(self, tmp_path):
        path = str(tmp_path / "bad.json")
        with open(path, "w") as f:
            json.dump({"schema": "repro.run_telemetry.v1"}, f)
        with pytest.raises(ValueError, match="missing keys"):
            obs.load_run_telemetry(path)
        with open(path, "w") as f:
            json.dump({"schema": "nope", "run": {}, "counters": {}, "gauges": {},
                       "histograms": {}}, f)
        with pytest.raises(ValueError, match="unknown RUN_TELEMETRY"):
            obs.load_run_telemetry(path)


# --- the same names and values as the reference -----------------------------

#: Values that differ between the packages, each with its reason: the
#: watchdog's floats come from training, which torch and XLA sum in
#: different orders (phi agrees to 5e-4 after a chunk, ``test_torch_dsgl``).
FLOAT_GAUGES = {"health.loss": 1e-3, "health.update_norm": 1e-3, "health.phi_norm": 1e-3}


def _scenario(pkg: str, graph, root: str):
    """A supervised fixed-mode run with snapshots, a round crash and a
    healed NaN, in either package; returns the registry snapshot."""
    if pkg == "port":
        o, pipeline_cls = obs, StreamingEmbedPipeline
        faults_mod = __import__("repro_torch.runtime.faults", fromlist=["x"])
        health_mod = __import__("repro_torch.runtime.health", fromlist=["x"])
        policy, spec, rounds, dsgl = _plan()
        resume_kw = {"device": "cpu"}
    else:
        from repro import obs as o
        from repro.core.api import EmbedConfig as RefEmbedConfig
        from repro.core.api import make_walk_plan as ref_plan
        from repro.core.dsgl import DSGLConfig as RefDSGLConfig
        from repro.runtime import faults as faults_mod
        from repro.runtime import health as health_mod
        from repro.runtime.trainer import StreamingEmbedPipeline as pipeline_cls

        policy, spec, rounds = ref_plan(RefEmbedConfig(**PLAN))
        dsgl = RefDSGLConfig(**DSGL)
        resume_kw = {}
    o.reset()
    o.configure(enabled=True, clear_sinks=True)
    faults = faults_mod.FaultInjector({"round": [1]}, inject_plan={"phi_nan": [3]})
    health = health_mod.HealthMonitor(health_mod.HealthConfig(check_every=1))
    state = {"p": pipeline_cls(graph, policy, spec, rounds, dsgl, health=health)}

    def recover(i):
        state["p"] = pipeline_cls.resume(root, policy, spec, dsgl, health=health, **resume_kw)

    faults_mod.run_with_restarts(
        lambda i: state["p"].run(ckpt_root=root, ckpt_every_rounds=1, faults=faults),
        recover=recover)
    snap = o.REGISTRY.snapshot()
    o.reset()
    return snap


def test_counters_and_gauges_match_the_reference(graph, tmp_path):
    from repro.graph.generators import rmat_graph as ref_rmat

    ref = _scenario("reference", ref_rmat(128, 7, seed=7), str(tmp_path / "ref"))
    got = _scenario("port", graph, str(tmp_path / "port"))
    assert sorted(got["counters"]) == sorted(ref["counters"])
    assert sorted(got["gauges"]) == sorted(ref["gauges"])
    assert sorted(got["histograms"]) == sorted(ref["histograms"])
    assert got["counters"] == ref["counters"]
    assert got["counters"]["pipeline.heals"] == 1 and got["counters"]["faults.fired.round"] == 1
    for name, want in ref["gauges"].items():
        if name in FLOAT_GAUGES:
            assert got["gauges"][name] == pytest.approx(want, rel=FLOAT_GAUGES[name]), name
        else:
            assert got["gauges"][name] == want, name
    for name, want in ref["histograms"].items():       # times differ; the counts do not
        assert got["histograms"][name]["count"] == want["count"], name


# --- telemetry on and off: bit-equal results --------------------------------


def _run_plain(graph, enabled):
    with obs.override(enabled=enabled):
        p = _pipeline(graph)
        p.run()
        return p.phi_in.clone(), p.phi_out.clone(), p.ring.walks.clone()


def _run_heal(graph, root, enabled):
    """Divergence -> rollback -> replay at lr_backoff 1.0 (bit-neutral)."""
    with obs.override(enabled=enabled):
        p = _pipeline(graph, health=HealthMonitor(HealthConfig(check_every=1, lr_backoff=1.0)))
        p.run(ckpt_root=root, ckpt_every_rounds=1,
              faults=FaultInjector(inject_plan={"phi_nan": [2]}))
        assert p.health.rollbacks == 1
        return p.phi_in.clone(), p.phi_out.clone(), p.ring.walks.clone()


def _run_resumed(graph, root, enabled):
    """Snapshots every round; the oldest resumed and run to the end."""
    policy, spec, _, dsgl = _plan()
    with obs.override(enabled=enabled):
        _pipeline(graph).run(ckpt_root=root, ckpt_every_rounds=1)
        oldest = min(int(d.split("_")[-1]) for d in os.listdir(root) if d.startswith("step_"))
        q = StreamingEmbedPipeline.resume(root, policy, spec, dsgl, step=oldest, device="cpu")
        q.run()
        return q.phi_in.clone(), q.phi_out.clone(), q.ring.walks.clone()


@pytest.fixture(scope="module")
def telemetry_off(graph):
    return _run_plain(graph, False)


@pytest.mark.parametrize("case", ["plain", "heal", "resume"])
def test_bit_identity_on_vs_off(graph, telemetry_off, tmp_path, case):
    """Telemetry on against the uninterrupted run with telemetry off: a
    plain run, a healed run and a resumed run land on the same bits."""
    if case == "plain":
        on = _run_plain(graph, True)
    elif case == "heal":
        on = _run_heal(graph, str(tmp_path / "on"), True)
        assert all(torch.equal(a, b) for a, b in zip(on, _run_heal(
            graph, str(tmp_path / "off"), False)))
    else:
        on = _run_resumed(graph, str(tmp_path / "on"), True)
    for a, b in zip(on, telemetry_off):
        assert torch.equal(a, b)
