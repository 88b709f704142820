"""The trainers: the LM trainer (``Trainer``: an autograd step,
step-granular checkpoints, restarts, a straggler-mitigated input stream),
the fused walk -> train embedding pipeline (``StreamingEmbedPipeline``)
and the two-phase embedding trainer over a materialized corpus
(``DSGLTrainer``).

The LM trainer is the reference's: an encoder-decoder model's batch adds
the step's source frames, (batch, seq_len // 2, d_model) float32 from
``np.random.default_rng(step)`` as the reference's; ``make_train_step``
takes the loss and its gradients by autograd (on the card K2 and K3 run
the forward pass inside their autograd wrappers, whose backward is the
plain versions'), then ``optim.opt_update`` in place; ``run`` checkpoints every
``ckpt_every`` steps in the ``ckpt`` layout, ``FailureInjector`` raises a
simulated node failure at a chosen step, and ``run_with_restarts`` resumes
from the newest checkpoint, replaying nothing: the batches are pure
functions of the step, so a restarted run ends bit-equal to an
uninterrupted one.

Walk rounds append into a device-resident ``CorpusRing``; DSGL training
consumes ring slots through one device gather per chunk of lifetimes, so
walks never round-trip through host numpy between sampler and learner.

Per round r the host (1) reads the (|V|,) occurrence counts back once —
the Eq. 7 controller input, also used to build the round's negative alias
table; (2) trains on round r's slots; (3) if the controller says continue,
walks round r+1 and appends it. After sampling stops, training keeps
consuming re-shuffled ring slots until the learning-rate schedule, fixed a
priori at ``epochs * max_rounds * steps_per_round`` steps, completes.

On the card each chunk of ``sync_period`` steps is one CUDA graph replay
(``dsgl.ChunkGraphs``): the ring gather and the negative draws fill its
static buffers, then the C steps run without the host.

Every source of randomness is keyed off the run's state: round keys are
fold_in(key_walk, r), chunk keys fold_in(key_train, global_step), so a run
is a pure function of the graph and the configuration.

With ``num_shards`` = S > 1 (the paper's distributed regime) DSGL trains
S replicas of the embedding matrices, each on its own ring slots, and a
chunk that crosses a ``sync_period`` boundary of global steps ends with the
hotness-block sync (Improvement-III); ``embeddings()`` is the replica mean.
With an MPGP assignment the walks run on the partition-sharded engine over
``walk_shards`` shards (``core.shard_engine``, the reference's default
engine for one device): the same walks as the dense engine's, and the walk
statistics carry the InCoM messages it exchanged (``msg_count``,
``msg_bytes`` measured, ``msg_bytes_analytic``; bytes summed in float32,
as the reference's).

With ``WalkSpec.rng_mode == "vertex"`` the pipeline can absorb edge churn
(``refresh``, driven by ``core.incremental``): a host mirror of the ring
says which root and which round every slot holds, so the walks of affected
roots are walked again under their rounds' keys and spliced into their
slots, the ΔD gate continues from the run's history, and DSGL fine-tunes in
place through the same CUDA graphs.

The run loop is a state machine over persisted cursors: ``save`` writes an
atomic snapshot in the reference's on-disk layout (``ckpt.checkpoint``),
``resume`` continues a crashed run bit for bit from the port's or the
reference's snapshot, and with a ``runtime.health.HealthMonitor`` attached
a divergence rolls the run back to its newest snapshot in place. ``save``'s
``meta_extra`` stamps the caller's fields into the snapshot's meta (the
ingest driver's ``applied_seq``). The ``runtime.faults`` injection points
fire where the reference's do, and the run reports to ``obs`` what the
reference's does, from values it already holds on the host.

Elastic walk shards: ``run(liveness=LivenessProbe(...))`` polls the
shards at the top of every round; a shard that misses its probes is
reassigned to the survivors (``elastic_reconfigure``: MPGP streams its
nodes into them, its resident walks are walked again under their rounds'
keys), and one that answers again grows the walk dispatch back
(``elastic_rejoin``). With vertex keys a walk depends on neither the shard
count nor the assignment, so ring and phi stay on the fault-free run's
bits; the next round's walk is the first dispatched at the new k. The DSGL
replica count and the training's CUDA graphs do not change.
``recover_shard_loss`` walks a lost shard's resident walks again in place.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.ckpt.checkpoint import (copy_into, latest_step, load_checkpoint, prune_steps,
                                         save_checkpoint)
from repro_torch.common.logging import get_logger, log_context
from repro_torch.convert import graph_from_arrays
from repro_torch.core.corpus import (Corpus, CorpusRing, FrequencyOrder, ring_append,
                                     ring_export, ring_replace, ring_to_numpy)
from repro_torch.core.dsgl import (ChunkGraphs, build_alias_table, init_embeddings, train_chunk,
                                   train_chunk_checked_in_place)
from repro_torch.core.info import relative_entropy_dpq
from repro_torch.core.sync import replica_mean, sample_hotness_rows
from repro_torch.core.termination import WalkCountController
from repro_torch.core.walker import (MAX_LANES, LaneKeys, VertexKeys, WalkerBatchState,
                                     run_walk_batch)
from repro_torch.data.pipeline import BackupShardFetcher, TokenStream, ring_chunk_indices
from repro_torch.device import resolve_device, synced_clock
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.delta import graph_version
from repro_torch.models import zoo
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import AdamWConfig, init_opt_state, leaves, opt_update
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime.faults import (NULL_INJECTOR, FailureInjector, FaultInjector,
                                        SimulatedFailure)
from repro_torch.runtime.health import DivergenceError

log = get_logger("repro_torch.runtime.trainer")

#: The walk counters the pipeline accumulates (and snapshots).
STAT_KEYS = ("supersteps", "accepts", "rejects", "msg_count", "msg_bytes", "msg_bytes_analytic")
#: The watchdog's reductions of a checked chunk (``dsgl.chunk_health``).
HEALTH_KEYS = ("nonfinite", "loss_nonfinite", "loss_sum", "update_norm", "phi_norm")


# ---------------------------------------------------------------------------
# The LM trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 20
    ckpt_every: int = 5
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    batch: int = 4
    seq_len: int = 64
    lr: float = 3e-4
    warmup: int = 10
    seed: int = 0
    straggler_deadline_s: float = 5.0


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, schedule):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics): the
    loss and the gradient of every parameter leaf by autograd, then one
    optimizer step in place at ``schedule(step)``. ``metrics`` holds the
    loss, the gradient's global norm (before the clip) and the lr as 0-d
    float32 tensors."""
    loss_of = zoo.loss_fn(cfg)

    def step_fn(params, opt_state, batch, step):
        lr = schedule(step)
        flat = leaves(params)
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            loss = loss_of(params, batch)
            grads = torch.autograd.grad(loss, flat)
        params, opt_state, gnorm = opt_update(list(grads), opt_state, params, opt_cfg, lr)
        return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm, "lr": lr}

    return step_fn


class Trainer:
    """The reference's LM trainer on ``device`` (the card unless the caller
    asks for the CPU): ``init_state`` draws the parameters with a
    ``torch.Generator`` seeded with ``tcfg.seed`` (not JAX's bits: a test
    passes a converted reference state through ``run(start_state=...)``)."""

    def __init__(self, model_cfg: ModelConfig, tcfg: TrainerConfig,
                 injector: Optional[FailureInjector] = None,
                 delay_injector: Optional[Callable[[int], float]] = None,
                 device="cuda"):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.injector = injector or FailureInjector()
        self.opt_cfg = AdamWConfig(moment_dtype=model_cfg.opt_state_dtype)
        self.schedule = cosine_warmup(tcfg.lr, tcfg.warmup, tcfg.steps)
        self.step_fn = make_train_step(model_cfg, self.opt_cfg, self.schedule)
        stream = TokenStream(vocab_size=model_cfg.vocab_size, batch_per_shard=tcfg.batch,
                             seq_len=tcfg.seq_len, seed=tcfg.seed)
        self.fetcher = BackupShardFetcher(primary=stream.batch_at, backup=stream.batch_at,
                                          deadline_s=tcfg.straggler_deadline_s,
                                          delay_injector=delay_injector)
        self.metrics_log: list = []

    # --- state ----------------------------------------------------------------
    def init_state(self):
        params = zoo.init_params(self.model_cfg, seed=self.tcfg.seed, device=self.device)
        return {"params": params, "opt": init_opt_state(params, self.opt_cfg)}

    def save(self, state, step: int):
        save_checkpoint(self.tcfg.ckpt_dir, step, state,
                        meta={"data_step": step, "seed": self.tcfg.seed})

    def try_restore(self, state) -> Optional[int]:
        """Load the newest checkpoint into ``state``'s tensors in place and
        return its data step; None when there is no checkpoint."""
        last = latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return None
        _, arrays, meta = load_checkpoint(self.tcfg.ckpt_dir, last)
        copy_into(state, arrays)
        return int(meta["data_step"])

    # --- loops ----------------------------------------------------------------
    def run(self, start_state=None, start_step: int = 0) -> Dict[str, Any]:
        """Run to completion or until an (injected) failure propagates. The
        state's tensors are updated in place."""
        state = start_state if start_state is not None else self.init_state()
        step = start_step
        while step < self.tcfg.steps:
            self.injector.check(step)
            batch = {k: torch.from_numpy(v).to(self.device, torch.int64)
                     for k, v in self.fetcher.fetch(step).items()}
            if self.model_cfg.encdec:
                # the reference's stub source for the step: numpy, so the same bits
                frames = np.random.default_rng(step).normal(
                    size=(self.tcfg.batch, self.tcfg.seq_len // 2, self.model_cfg.d_model))
                batch["frames"] = torch.from_numpy(frames.astype(np.float32)).to(self.device)
            params, opt, metrics = self.step_fn(state["params"], state["opt"], batch, step)
            state = {"params": params, "opt": opt}
            self.metrics_log.append({k: float(v) for k, v in metrics.items()} | {"step": step})
            step += 1
            if step % self.tcfg.ckpt_every == 0 or step == self.tcfg.steps:
                self.save(state, step)
        return {"state": state, "final_step": step, "metrics": self.metrics_log,
                "straggler_stats": self.fetcher.stats}

    def run_with_restarts(self, max_restarts: int = 4) -> Dict[str, Any]:
        """The cluster agent's loop: on a failure, restart from the newest
        checkpoint, loaded into the live state's tensors (one state on the
        device). ``run`` steps the state in place, so a failure before the
        first checkpoint restarts from a fresh ``init_state``: seeded, the
        same start."""
        state, restarts = self.init_state(), 0
        while True:
            start = self.try_restore(state)
            if start is None:
                if restarts:
                    state = None            # free the stepped state before drawing again
                    state = self.init_state()
                start = 0
            try:
                out = self.run(start_state=state, start_step=start)
                out["restarts"] = restarts
                return out
            except SimulatedFailure:
                restarts += 1
                if restarts > max_restarts:
                    raise


class StreamingEmbedPipeline:
    """walks -> device corpus ring -> DSGL, on one device, with durable
    snapshots and the divergence watchdog."""

    def __init__(self, graph, policy, spec, rounds_cfg: Dict, dsgl_cfg, *,
                 assignment: Optional[np.ndarray] = None, num_shards: int = 1,
                 walker_batch: int = 4096, health=None):
        self.cm_seconds = 0.0
        if getattr(policy, "needs_edge_cm", False) and graph.edge_cm is None:
            t0 = time.perf_counter()
            graph = graph.with_edge_cm()
            if graph.device.type == "cuda":
                torch.cuda.synchronize(graph.device)
            self.cm_seconds = time.perf_counter() - t0
        self.graph = graph
        self.device = graph.device
        self.policy = policy
        self.spec = spec
        self.cfg = dsgl_cfg
        self.num_shards = max(num_shards, 1)
        # The walk shard count starts at the replica count; the two are
        # independent (the reference's elastic path changes the first only).
        self.walk_shards = self.num_shards
        self.assignment = (None if assignment is None
                           else np.asarray(assignment, dtype=np.int32))
        # The reference dispatches a round in chunks of ``walker_batch``
        # sources; the port walks up to MAX_LANES lanes a batch, and
        # ``walker_batch`` keeps the cadence of the ``superstep`` fault point.
        self.walker_batch = int(walker_batch)
        self.health = health            # optional runtime.health.HealthMonitor
        self._lr_scale = 1.0            # the watchdog's rollback backoff (persisted)
        self._faults: FaultInjector = NULL_INJECTOR
        self._snapshot_hooks: List[Callable] = []
        self._reconfigs: List[Dict[str, Any]] = []   # elastic deaths and re-joins, in order
        self._rounds_cfg = dict(rounds_cfg)
        self.controller = WalkCountController(**rounds_cfg)
        self.degrees = graph.degrees().cpu().numpy()

        n = graph.num_nodes
        self.sources = torch.arange(n, device=self.device)
        self._sources_host = np.arange(n, dtype=np.int64)
        # Retain as many full rounds as fit a ~0.5 GB slot budget; older
        # rounds retire on wrap. One round is the floor.
        budget_rounds = max(1, (1 << 27) // max(spec.max_len * n, 1))
        self.ring_rounds = min(self.controller.max_rounds, budget_rounds)
        if self.ring_rounds * n * spec.max_len >= 2**31:
            raise ValueError(
                f"one walk round (|V|={n} x max_len={spec.max_len}) exceeds "
                "the device corpus-ring budget")
        self.ring = CorpusRing.create(self.ring_rounds * n, spec.max_len, n,
                                      self.device)
        per = dsgl_cfg.batch_groups * dsgl_cfg.multi_windows
        self.steps_per_round = max(n // self.num_shards // per, 1)
        self.total_steps = (dsgl_cfg.epochs * self.controller.max_rounds
                            * self.steps_per_round)
        self.global_step = 0
        self.chunks = 0                          # training chunks run
        self.syncs = 0                           # chunks that ended with a hotness sync
        self.sync_bytes = 0.0                    # the reference's byte count of those syncs
        self.steps_run = 0                       # steps trained by this object, replays included
        self.checked_chunks = 0                  # chunks the watchdog checked
        self.snapshot_log: List[Dict[str, Any]] = []   # committed snapshots: seq, bytes, seconds
        self._graphs = ChunkGraphs() if self.device.type == "cuda" else None
        self._pre = None            # (phi_in, phi_out) before a checked chunk

        key = prng.PRNGKey(dsgl_cfg.seed)
        self.key_walk, self.key_train, *rep_keys = prng.split(key, 2 + self.num_shards)
        reps = [init_embeddings(n, dsgl_cfg.dim, k, self.device) for k in rep_keys]
        self.phi_in = torch.stack([r[0] for r in reps])      # (S, N, d)
        self.phi_out = torch.stack([r[1] for r in reps])
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        zero_f = torch.zeros((), dtype=torch.float32, device=self.device)
        self._stats: Dict[str, Any] = {"supersteps": 0, "accepts": zero, "rejects": zero,
                                       "msg_count": zero, "msg_bytes": zero_f,
                                       "msg_bytes_analytic": zero_f}
        self.batch_supersteps: List[int] = []   # supersteps of every walk batch
        self.phase_s = {"walk": 0.0, "train": 0.0}  # host wall time per phase
        self._ft = None             # (start step, steps, lr0): a refresh's fine-tune schedule
        # Host mirror of the ring: the root vertex and the walk round each
        # slot holds (-1: never written), kept at every append from the
        # batches' sources, so a refresh finds every resident walk of an
        # affected root and its round's key after partial rounds and wraps.
        self._slot_root = np.full(self.ring.capacity, -1, np.int64)
        self._slot_round = np.full(self.ring.capacity, -1, np.int64)
        # The run's cursors, all persisted by ``save``: the run loop is a
        # state machine over phase rounds -> tail -> done, with
        # ``_trained_rounds`` rounds fully trained and ``_rounds_walked``
        # appended, so a resumed run re-enters the round its snapshot
        # committed and replays forward bit for bit.
        self._rounds_walked = 0
        self._trained_rounds = 0
        self._phase = "rounds"
        self._ckpt_seq = 0              # snapshot numbering (monotonic)
        self._ckpt_root: Optional[str] = None
        self._ckpt_every = 0
        self._ckpt_tick = 0
        self._ckpt_keep: Optional[int] = None

    def adopt_state(self, state: Dict[str, Any]) -> None:
        """Continue from imported state (``convert.from_reference_state``):
        the (S, N, d) replica matrices, the ring, both RNG keys, the MPGP
        assignment and the walk shard count when the state has them, and
        the ring's slot maps and the ΔD history when it has them (a refresh
        needs both)."""
        if state["phi_in"].shape[0] != self.num_shards:
            raise ValueError(f"state has {state['phi_in'].shape[0]} replicas, the pipeline "
                             f"{self.num_shards}")
        self.phi_in = state["phi_in"].to(self.device)
        self.phi_out = state["phi_out"].to(self.device)
        if state.get("assignment") is not None:
            self.assignment = np.asarray(state["assignment"], dtype=np.int32)
        if state.get("walk_shards") is not None:
            self.walk_shards = int(state["walk_shards"])
        self.ring = state["ring"]
        self.key_walk, self.key_train = state["key_walk"], state["key_train"]
        if state.get("slot_root") is not None:
            self._slot_root = np.array(state["slot_root"], np.int64)
            self._slot_round = np.array(state["slot_round"], np.int64)
            self._rounds_walked = int(self._slot_round.max()) + 1
        if state.get("d_history") is not None:
            c = self.controller
            self.controller = WalkCountController(
                delta=c.delta, min_rounds=c.min_rounds, max_rounds=c.max_rounds,
                window=c.window, seed_history=list(state["d_history"]))
        if self._graphs is not None:              # the graphs hold the old phi
            self._graphs = ChunkGraphs()

    # --- walk side --------------------------------------------------------
    def _run_round(self, r: int, sources: Optional[np.ndarray] = None,
                   faults: FaultInjector = NULL_INJECTOR
                   ) -> List[Tuple[np.ndarray, WalkerBatchState]]:
        """Walk round r from every source (or from ``sources``, host int64);
        returns (batch sources on the host, state) pairs. With lane keys,
        lane i draws what the reference pipeline's lane i draws: the key of
        its 4,096-source chunk (``walker.REF_CHUNK``) is fold_in(round_key,
        chunk start). With vertex keys every batch walks under the round key
        and a walk depends on its source alone, so a subset of a round walks
        as it did in the full round. With an assignment the batches run on
        the partition-sharded engine.

        ``faults`` fires the ``superstep`` point once per ``walker_batch``
        sources, before their batch walks: a crash there loses the round,
        none of whose walks is committed yet."""
        round_key = prng.fold_in(self.key_walk, r)
        shards = self.walk_shards if self.assignment is not None else None
        by_vertex = self.spec.rng_mode == "vertex"
        if sources is None:
            host, dev_src = self._sources_host, self.sources
        else:
            if not by_vertex:
                raise ValueError("a subset of a round needs vertex-keyed walks")
            host = np.asarray(sources, np.int64)
            dev_src = torch.from_numpy(host).to(self.device)
        wb = max(self.walker_batch, 1)
        pairs = []
        with obs.trace_span("walk.round", round=r, walks=len(host)):
            for start in range(0, len(host), MAX_LANES):
                stop = min(start + MAX_LANES, len(host))
                for at in range(-(-start // wb) * wb, stop, wb):
                    faults.fire("superstep", f"round {r} chunk @{at}")
                chunk = dev_src[start:stop]
                keys = (VertexKeys(round_key, chunk) if by_vertex else
                        LaneKeys.for_round(round_key, start, len(chunk), self.device))
                pairs.append((host[start:stop],
                              run_walk_batch(self.graph, chunk, keys, self.policy, self.spec,
                                             self.assignment, num_shards=shards)))
                obs.inc("walk.batches")
            obs.inc("walk.dispatched", len(host))
        return pairs

    def _account(self, st: WalkerBatchState) -> None:
        self._stats["supersteps"] += st.supersteps
        for name in STAT_KEYS[1:]:
            self._stats[name] = self._stats[name] + getattr(st, name)
        self.batch_supersteps.append(st.supersteps)

    def _append(self, pairs, round_idx: int) -> None:
        cap = self.ring.capacity
        for chunk, st in pairs:
            slots = (self.ring.cursor + np.arange(len(chunk))) % cap
            ring_append(self.ring, st.path, st.info.L)
            self._slot_root[slots] = chunk
            self._slot_round[slots] = round_idx
            self._account(st)

    # --- train side -------------------------------------------------------
    def _lrs(self, count: int) -> np.ndarray:
        # _lr_scale is the watchdog's backoff multiplier: 1.0 until it ever
        # trips, and a multiply by exactly 1.0 changes no bit.
        start, total, lr0 = (0, self.total_steps, self.cfg.lr) if self._ft is None \
            else self._ft                     # a refresh's fine-tune mini-schedule
        fracs = (self.global_step - start + np.arange(count)) / max(total, 1)
        return np.maximum(lr0 * self._lr_scale * (1.0 - fracs),
                          self.cfg.min_lr).astype(np.float32)

    def _train_slots(self, base: int, pool: int, ocn_host: np.ndarray,
                     steps: int, table=None, order=None) -> None:
        """Train ``steps`` lifetime batches over ring slots [base, base+pool).

        ``table``/``order`` let the schedule tail, whose ocn is frozen, build
        the alias table and the frequency order once. With S > 1 replicas,
        the hotness rows of the syncs of this call come from one generator
        seeded by the call's first global step, as the reference's do.

        With a ``HealthMonitor`` attached, the chunks it names by global step
        are checked in place against a persistent pre-chunk copy of phi
        (``train_chunk_checked_in_place``; on the card the same graph, phi
        bit-equal to an unchecked chunk's), and the five health scalars come
        to the host in one transfer. The
        ``phi_nan`` and ``lr_spike`` corruption sites of the fault injector
        poison a chunk's input for the watchdog to catch."""
        cfg = self.cfg
        if table is None:
            table = build_alias_table(ocn_host, cfg.neg_power, self.device)
        replicated = self.num_shards > 1
        rng = np.random.default_rng(cfg.seed * 9176 + self.global_step)
        if order is None and replicated:
            order = FrequencyOrder.from_ocn(ocn_host)
        blocks = None
        chunk = max(min(cfg.sync_period, steps), 1)
        train = self._graphs.train_chunk if self._graphs is not None else train_chunk
        tele = obs.enabled()
        done = 0
        while done < steps:
            t_c = time.perf_counter() if tele else 0.0
            count = min(chunk, steps - done)
            # One hotness exchange per sync_period global steps (not per
            # chunk): a chunk that crosses a period boundary ends with one.
            sync_now = replicated and (self.global_step // cfg.sync_period
                                       != (self.global_step + count) // cfg.sync_period)
            idx = ring_chunk_indices(
                prng.fold_in(self.key_train, self.global_step), base, pool,
                count, self.num_shards, cfg.batch_groups, cfg.multi_windows,
                self.device)
            walks = self.ring.walks[idx]                   # (C,S,G,W,T) gather
            rows = None
            if sync_now:
                if blocks is None:
                    blocks = order.hotness_blocks()
                rows_rank = sample_hotness_rows(*blocks, rng)
                rows = torch.from_numpy(order.to_node[rows_rank].astype(np.int64))
                if self.device.type == "cuda":    # no wait for the queued chunks
                    rows = rows.pin_memory().to(self.device, non_blocking=True)
                self.syncs += 1
                self.sync_bytes += float(rows.numel() * cfg.dim * 4 * self.num_shards * 2)
            key = prng.fold_in(self.key_train,
                               2 * self.total_steps + self.global_step)
            lrs = self._lrs(count)
            if self._faults.inject("phi_nan"):    # in place: the graphs' storage
                self.phi_in[:, :4, :] = float("nan")
            if self._faults.inject("lr_spike"):
                lrs = lrs * np.float32(1e4)
            check = self.health is not None and self.health.due(self.global_step, count)
            args = (walks, table, key, lrs, cfg.window, cfg.negatives)
            if not check:
                train(self.phi_in, self.phi_out, *args, sync_rows=rows, sync=sync_now)
            else:
                _, health = train_chunk_checked_in_place(
                    train, self._pre_chunk(), self.phi_in, self.phi_out, *args,
                    sync_rows=rows, sync=sync_now)
            self.global_step += count
            self.steps_run += count
            self.chunks += 1
            done += count
            if tele:
                obs.observe("train.chunk_dispatch.s", time.perf_counter() - t_c)
                obs.inc("train.steps", count)
            if check:
                self.checked_chunks += 1
                # One host pull of the five scalars; raises DivergenceError
                # on a verdict, which run()'s heal loop answers.
                values = torch.stack([health[k].to(torch.float64)
                                      for k in HEALTH_KEYS]).cpu().tolist()
                self.health.observe(dict(zip(HEALTH_KEYS, values)), step=self.global_step,
                                    count=count, slots=np.unique(idx.cpu().numpy()))

    # --- run loop ---------------------------------------------------------
    def _timed(self, phase: str, fn, *args, **kwargs) -> None:
        """Run one phase and add its wall time, the device drained at the end
        (one sync per round: the walk loop syncs every superstep anyway)."""
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phase_s[phase] += time.perf_counter() - t0

    def _walk(self, r: int, faults: FaultInjector) -> None:
        self._timed("walk", lambda: self._append(self._run_round(r, faults=faults), r))
        self._rounds_walked = r + 1

    def _train(self, *args, **kwargs) -> None:
        self._timed("train", self._train_slots, *args, **kwargs)

    def run(self, *, ckpt_root: Optional[str] = None, ckpt_every_rounds: int = 0,
            ckpt_keep: Optional[int] = None,
            faults: FaultInjector = NULL_INJECTOR, liveness=None) -> Dict[str, Any]:
        """Run (or continue, after ``resume``) the walk -> train lifecycle:
        walk rounds gated by the ΔD controller, training each round, then
        the schedule-completion tail. Returns the run's summary.

        The loop is a state machine over persisted cursors: phase
        ``rounds`` trains round r = ``_trained_rounds`` with rounds 0..r
        appended and the ΔD gate holding r decisions; phase ``tail``
        consumes the frozen ring until the a-priori schedule completes.
        Every iteration boundary is a consistent cut, and every source of
        randomness is keyed off persisted state (round keys fold_in(key_walk,
        r), chunk keys fold_in(key_train, global_step), hotness rows seeded
        by global_step), so a resumed run replays the rest bit for bit.
        The port walks round r+1 after training round r (the reference's
        ``overlap=False`` order); the cursors mean what the reference's do
        at every snapshot.

        ``ckpt_root`` / ``ckpt_every_rounds`` take a snapshot every N round
        or tail iterations and a final one; ``ckpt_keep`` bounds retention;
        ``faults`` is the injection harness (the default never fires). With
        a ``HealthMonitor`` attached, a divergence verdict rolls the
        pipeline back to the newest snapshot in place, backs the learning
        rate off by ``lr_backoff``, walks the offending chunk's roots again
        (vertex keys) and re-enters the loop, at most
        ``HealthConfig.max_rollbacks`` times. With a
        ``runtime.faults.LivenessProbe`` the top of every round polls the
        walk shards: a shard dead by the probe is reassigned
        (``elastic_reconfigure``) and a returned one re-joins
        (``elastic_rejoin``), each followed by a snapshot when snapshots
        are on."""
        t0 = time.perf_counter()
        self._ckpt_root, self._ckpt_every = ckpt_root, ckpt_every_rounds
        self._ckpt_keep = ckpt_keep
        self._faults = faults
        try:
            if self.health is not None and ckpt_root and latest_step(ckpt_root) is None:
                # The watchdog needs a rollback base before its first check.
                self.save(ckpt_root, faults=faults)
            while True:
                try:
                    result = self._run_phases(faults, liveness)
                    break
                except DivergenceError as err:
                    self._heal_divergence(err, faults)
        finally:
            self._faults = NULL_INJECTOR
        result["wall_s"] = time.perf_counter() - t0
        return result

    def _run_phases(self, faults: FaultInjector, liveness) -> Dict[str, Any]:
        n = len(self.sources)
        if self._phase == "rounds":
            if self._rounds_walked == 0:
                self._walk(0, faults)
            while True:
                r = self._trained_rounds
                with log_context(round=r):
                    faults.fire("round", r)
                    # Rounds 0..r are walked: a new layout dispatches round r+1.
                    self._poll_liveness(liveness, faults)
                    ocn_host = self.ring.ocn.cpu().numpy()            # per-round sync
                    cont = self.controller.update_d(
                        relative_entropy_dpq(self.degrees, ocn_host))
                    self._train((r * n) % self.ring.capacity, n, ocn_host,
                                self.steps_per_round)
                    self._trained_rounds = r + 1
                    if not cont:
                        break
                    self._walk(r + 1, faults)
                    self._maybe_snapshot(faults)
            self._phase = "tail"
            obs.span_event("pipeline.phase", phase="tail", round=self._trained_rounds,
                           step=self.global_step)
            self._maybe_snapshot(faults)

        if self._phase == "tail":
            # Re-consume the filled ring until the a-priori lr schedule ends.
            # ocn is frozen now, so one alias table and one frequency order
            # serve every iteration (and a resume rebuilds them identically).
            ocn_host = self.ring.ocn.cpu().numpy()
            filled = self.ring.num_filled
            table = build_alias_table(ocn_host, self.cfg.neg_power, self.device)
            order = FrequencyOrder.from_ocn(ocn_host) if self.num_shards > 1 else None
            while self.global_step < self.total_steps:
                faults.fire("tail", self.global_step)
                self._train(0, filled, ocn_host,
                            min(self.steps_per_round, self.total_steps - self.global_step),
                            table=table, order=order)
                self._maybe_snapshot(faults)
            self._phase = "done"
            obs.span_event("pipeline.phase", phase="done", step=self.global_step)
            if self._ckpt_root and self._ckpt_every:
                self.save(self._ckpt_root, faults=faults)           # final snapshot

        phi_in, phi_out = self.embeddings()
        stats = self.stats()
        if obs.enabled():       # values the run already read back for its summary
            for k in STAT_KEYS:
                obs.set_gauge(f"walk.{k}", stats[k])
            obs.set_gauge("walk.mean_len", stats["mean_len"])
            obs.set_gauge("walk.rounds", self.controller.rounds)
            obs.set_gauge("train.global_step", self.global_step)
        return {
            "phi_in": phi_in, "phi_out": phi_out,
            "rounds": self.controller.rounds,
            "steps": self.global_step,
            "chunks": self.chunks,
            "syncs": self.syncs,
            "sync_bytes": self.sync_bytes,
            "ring": self.ring,
            "stats": stats,
            "cm_s": self.cm_seconds,
            "health": self.health.report() if self.health is not None else None,
            "reconfigs": list(self._reconfigs),
            "lr_scale": float(self._lr_scale),
        }

    def stats(self) -> Dict[str, Any]:
        stats = {k: float(v) if k.startswith("msg_bytes") else int(v)
                 for k, v in self._stats.items()}
        stats["mean_len"] = (float(self.ring.lengths.sum())
                             / max(self.ring.num_filled, 1))
        stats["d_history"] = list(self.controller.history)
        stats["batch_supersteps"] = list(self.batch_supersteps)
        stats["phase_s"] = dict(self.phase_s)
        return stats

    def corpus(self) -> Corpus:
        """The ring as a host ``Corpus`` (API boundary only)."""
        walks, lengths = ring_to_numpy(self.ring)
        stats = self.stats()
        stats["mean_len"] = float(lengths.mean()) if len(lengths) else 0.0
        return Corpus(walks=walks, lengths=lengths,
                      ocn=self.ring.ocn.cpu().numpy().astype(np.int64),
                      rounds=self.controller.rounds, stats=stats)

    def embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Current (phi_in, phi_out) in node space, replica-averaged."""
        if self.num_shards > 1:
            return replica_mean(self.phi_in), replica_mean(self.phi_out)
        return self.phi_in[0], self.phi_out[0]

    def _pre_chunk(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The persistent buffer pair a checked chunk copies phi into,
        allocated at the first check and again only when phi's shape moves."""
        if self._pre is None or self._pre[0].shape != self.phi_in.shape:
            self._pre = (torch.empty_like(self.phi_in), torch.empty_like(self.phi_out))
        return self._pre

    # --- crash-consistent snapshots ----------------------------------------
    def _maybe_snapshot(self, faults: FaultInjector) -> None:
        if not self._ckpt_root or not self._ckpt_every:
            return
        self._ckpt_tick += 1
        if self._ckpt_tick % self._ckpt_every == 0:
            self.save(self._ckpt_root, faults=faults)

    def _state_tree(self) -> Dict[str, Any]:
        """The snapshot's arrays, in the reference's names and dtypes: int32
        CSR arrays and assignment, uint32 keys of shape (2,), float32 walk
        counters."""
        g = self.graph
        graph = {"indptr": g.indptr.to(torch.int32), "indices": g.indices.to(torch.int32)}
        if g.weights is not None:
            graph["weights"] = g.weights.to(torch.float32)
        if g.edge_cm is not None:
            graph["edge_cm"] = g.edge_cm.to(torch.int32)
        stats = self.stats()
        tree = {
            "phi_in": self.phi_in,
            "phi_out": self.phi_out,
            "ring": ring_export(self.ring),
            "slot_root": self._slot_root,
            "slot_round": self._slot_round,
            "key_walk": np.asarray(self.key_walk, np.uint32),
            "key_train": np.asarray(self.key_train, np.uint32),
            "stats": {k: np.float32(stats[k]) for k in STAT_KEYS},
            "graph": graph,
        }
        if self.assignment is not None:
            tree["assignment"] = np.asarray(self.assignment, np.int32)
        return tree

    def save(self, root: str, *, faults: FaultInjector = NULL_INJECTOR,
             meta_extra: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot the whole walk -> train state as one atomic checkpoint in
        the reference's layout (``ckpt.checkpoint``): the phi replicas, the
        ring (walks, lengths, ocn, cursor, total), the host slot maps, both
        RNG keys, the walk counters, the ΔD controller, the run's cursors,
        the MPGP assignment and the graph's CSR arrays, so a resume needs no
        graph handle. ``meta_extra`` adds its fields to the snapshot's meta.
        Returns the committed path.

        ``faults`` can crash the write two ways: ``ckpt_write`` fires before
        anything is written (the snapshot is lost), and ``torn("ckpt")``
        commits the directory, then corrupts its manifest and raises."""
        with obs.trace_span("ckpt.write", seq=self._ckpt_seq, round=self._trained_rounds,
                            step=self.global_step, phase=self._phase):
            return self._save_inner(root, faults, meta_extra)

    def _save_inner(self, root: str, faults: FaultInjector,
                    meta_extra: Optional[Dict[str, Any]]) -> str:
        faults.fire("ckpt_write", self._ckpt_seq)
        torn = faults.torn("ckpt")
        t0 = time.perf_counter()
        stats = self.stats()
        meta = {
            "kind": "streaming_pipeline",
            "global_step": int(self.global_step),
            "cursor": int(self.ring.cursor),
            "rounds_walked": int(self._rounds_walked),
            "trained_rounds": int(self._trained_rounds),
            "phase": self._phase,
            "controller": self.controller.to_state(),
            "rounds_cfg": self._rounds_cfg,
            "total_steps": int(self.total_steps),
            "num_shards": int(self.num_shards),
            "walk_shards": int(self.walk_shards),
            "lr_scale": float(self._lr_scale),
            "walker_batch": int(self.walker_batch),
            "overlap": False,
            "graph_version": int(graph_version(self.graph)),
            # The counters exactly (the float32 arrays round above 2**24).
            "walk_stats": {k: stats[k] for k in STAT_KEYS},
        }
        if meta_extra:
            meta.update(meta_extra)
        path = save_checkpoint(root, self._ckpt_seq, self._state_tree(), meta=meta)
        if torn:
            with open(os.path.join(path, "manifest.json"), "w") as f:
                f.write('{"step": ')          # the data blocks never reached the disk
            raise SimulatedFailure(f"torn checkpoint write at snapshot {self._ckpt_seq}")
        with log_context(round=self._trained_rounds, graph_version=meta["graph_version"]):
            log.info("snapshot %d committed at %s (phase=%s step=%d)",
                     self._ckpt_seq, path, self._phase, self.global_step)
        obs.inc("ckpt.writes")
        obs.set_gauge("ckpt.last_seq", self._ckpt_seq)
        self.snapshot_log.append({
            "seq": self._ckpt_seq, "phase": self._phase, "step": int(self.global_step),
            "bytes": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
            "write_s": time.perf_counter() - t0})
        seq = self._ckpt_seq
        self._ckpt_seq += 1
        if self._ckpt_keep:
            prune_steps(root, self._ckpt_keep)
        for hook in self._snapshot_hooks:
            hook(path, seq, meta)
        return path

    def add_snapshot_hook(self, hook: Callable) -> None:
        """Call ``hook(path, seq, meta)`` after every committed snapshot
        (after retention pruning, so the path is durable); never for a torn
        or crashed write."""
        self._snapshot_hooks.append(hook)

    @classmethod
    def resume(cls, root: str, policy, spec, dsgl_cfg, *, step: Optional[int] = None,
               health=None, device="cuda") -> "StreamingEmbedPipeline":
        """Rebuild a pipeline from the newest valid snapshot under ``root``
        (or ``step``), the port's or the reference's, on ``device``, and
        re-enter its cursors; ``run()`` continues it. The caller gives the
        plan (policy, spec, DSGL config); everything mutable, the graph
        included, comes from the snapshot. The new pipeline has fresh CUDA
        graphs."""
        dev = resolve_device(device)
        step_loaded, arrays, meta = load_checkpoint(root, step)
        _check_kind(meta, root, step_loaded)
        pipe = cls(_snapshot_graph(arrays, dev), policy, spec,
                   meta["rounds_cfg"], dsgl_cfg,
                   assignment=arrays.get("assignment"), num_shards=int(meta["num_shards"]),
                   walker_batch=int(meta.get("walker_batch", 4096)),
                   health=health)
        pipe._adopt_snapshot(root, step_loaded, arrays, meta)
        return pipe

    def _adopt_snapshot(self, root: str, step_loaded: int, arrays: Dict[str, np.ndarray],
                        meta: Dict[str, Any]) -> None:
        """Load a snapshot's state into this pipeline's own tensors (copied
        into their storage, so captured CUDA graphs stay valid), and report
        the resume."""
        ring = self.ring
        if arrays["ring/walks"].shape != tuple(ring.walks.shape):
            raise ValueError(f"snapshot ring {arrays['ring/walks'].shape} does not match the "
                             f"pipeline's {tuple(ring.walks.shape)}; resume with the spec the "
                             "snapshot was taken with")
        if arrays["phi_in"].shape != tuple(self.phi_in.shape):
            raise ValueError(f"snapshot phi {arrays['phi_in'].shape} does not match the "
                             f"pipeline's {tuple(self.phi_in.shape)}")
        for t, name in ((ring.walks, "ring/walks"), (ring.lengths, "ring/lengths"),
                        (ring.ocn, "ring/ocn"), (self.phi_in, "phi_in"),
                        (self.phi_out, "phi_out")):
            t.copy_(torch.from_numpy(np.ascontiguousarray(arrays[name])))
        ring.cursor = int(arrays["ring/cursor"])
        ring.total = int(arrays["ring/total"])
        self.key_walk = prng.key_of(arrays["key_walk"])
        self.key_train = prng.key_of(arrays["key_train"])
        exact = meta.get("walk_stats") or {k: arrays[f"stats/{k}"].item() for k in STAT_KEYS}
        self._stats = {"supersteps": int(exact["supersteps"])}
        for k in STAT_KEYS[1:]:
            dtype = torch.float32 if k.startswith("msg_bytes") else torch.int64
            value = float(exact[k]) if dtype == torch.float32 else int(exact[k])
            self._stats[k] = torch.tensor(value, dtype=dtype, device=self.device)
        self._slot_root = np.array(arrays["slot_root"], np.int64)
        self._slot_round = np.array(arrays["slot_round"], np.int64)
        self.controller = WalkCountController.from_state(meta["controller"])
        self.global_step = int(meta["global_step"])
        self.total_steps = int(meta["total_steps"])
        self._rounds_walked = int(meta["rounds_walked"])
        self._trained_rounds = int(meta["trained_rounds"])
        self._phase = meta["phase"]
        self.walk_shards = int(meta.get("walk_shards", meta["num_shards"]))
        self._lr_scale = float(meta.get("lr_scale", 1.0))
        self._ckpt_seq = step_loaded + 1
        log.info("resumed pipeline from %s snapshot %d (phase=%s round=%d step=%d)", root,
                 step_loaded, self._phase, self._trained_rounds, self.global_step)
        obs.span_event("ckpt.resume", snapshot=step_loaded, phase=self._phase,
                       round=self._trained_rounds, step=self.global_step)
        obs.inc("ckpt.resumes")

    # --- the self-healing runtime -------------------------------------------
    def _heal_divergence(self, err: DivergenceError, faults: FaultInjector) -> None:
        """Answer a watchdog verdict: roll back to the newest snapshot in
        place, back the learning rate off, walk the offending chunk's roots
        again under their rounds' keys (a no-op on a clean ring with vertex
        keys; it heals corrupt walk data) and let ``run`` re-enter the loop.
        Re-raises without a snapshot root or once ``max_rollbacks`` is spent:
        then the supervisor (``run_with_restarts``) is the layer to act."""
        report = err.report
        mon = self.health
        if not self._ckpt_root or mon is None or mon.exhausted():
            raise err
        # Slots -> roots before the restore: the snapshot's slot map may
        # predate the rounds the diverging chunk trained on.
        roots = self._slot_root[report.slots]
        roots = np.unique(roots[roots >= 0])
        self._restore_in_place()
        self._lr_scale *= mon.cfg.lr_backoff
        quarantined = 0
        if self.spec.rng_mode == "vertex" and len(roots):
            mask = np.zeros(len(self.sources), bool)
            mask[roots] = True
            quarantined, _ = self._rewalk_resident(mask, faults)
        mon.note_rollback(restored_step=self.global_step, lr_scale=self._lr_scale,
                          quarantined=quarantined)
        obs.span_event("pipeline.heal", kind=report.kind, detected_step=report.step,
                       restored_step=self.global_step, lr_scale=self._lr_scale,
                       quarantined=quarantined)
        obs.inc("pipeline.heals")
        log.warning("divergence (%s) at step %d: rolled back to step %d, lr scale now %.3g, "
                    "quarantined %d resident walks", report.kind, report.step,
                    self.global_step, self._lr_scale, quarantined)

    def _restore_in_place(self, root: Optional[str] = None) -> int:
        """Adopt the newest valid snapshot's state (under ``root``, by default
        the run's snapshot root) into THIS pipeline: the in-place form of
        ``resume``. phi and the ring are copied into their own storage, so
        the chunks' CUDA graphs stay valid and no second pipeline is held;
        the graph is replaced only when the snapshot's differs. The run's
        wiring (watchdog, snapshot hooks, the reconfiguration log) stays.
        Returns the restored global step."""
        root = self._ckpt_root if root is None else root
        step_loaded, arrays, meta = load_checkpoint(root)
        _check_kind(meta, root, step_loaded)
        g = self.graph
        same = all(name in arrays and np.array_equal(arrays[name], t.cpu().numpy())
                   for name, t in (("graph/indptr", g.indptr), ("graph/indices", g.indices))) \
            and ("graph/weights" in arrays) == (g.weights is not None)
        if not same:
            self.adopt_graph(_snapshot_graph(arrays, self.device))
        if "assignment" in arrays:
            self.assignment = np.asarray(arrays["assignment"], np.int32)
        self._adopt_snapshot(root, step_loaded, arrays, meta)
        self._ft = None
        self._ckpt_tick = 0
        return self.global_step

    # --- elastic walk shards ------------------------------------------------
    def _poll_liveness(self, liveness, faults: FaultInjector) -> None:
        """One probe sweep at a round boundary: a shard dead by the probe is
        reassigned to the survivors rather than stalling the round, and a
        returned one grows the dispatch back. A snapshot follows each (when
        snapshots are on), so a rollback never brings back a layout."""
        if liveness is None:
            return
        snapshot = bool(self._ckpt_root and (self._ckpt_every or self.health))
        for dead in liveness.poll(faults):
            name = liveness.names[dead]
            log.warning("walk shard %d (launch id %d) missed %d consecutive liveness probes: "
                        "reconfiguring elastically", dead, name, liveness.misses_to_dead)
            self.elastic_reconfigure(dead, faults=faults)["launch_id"] = int(name)
            liveness.remove(dead)
            if snapshot:
                self.save(self._ckpt_root, faults=faults)
        for name in liveness.rejoinable():
            log.info("walk shard (launch id %d) answered %d consecutive liveness probes: "
                     "growing back elastically", name, liveness.hits_to_live)
            self.elastic_rejoin(faults=faults)["launch_id"] = int(name)
            liveness.rejoin(name)
            if snapshot:
                self.save(self._ckpt_root, faults=faults)

    def _check_elastic(self, what: str) -> None:
        if self.assignment is None:
            raise ValueError(f"elastic {what} needs a shard assignment")
        if self.spec.rng_mode != "vertex":
            raise ValueError(f"elastic {what} requires WalkSpec.rng_mode='vertex' (walks must "
                             "not depend on the shard count or the assignment)")

    def elastic_reconfigure(self, dead_shard: int, *,
                            faults: FaultInjector = NULL_INJECTOR) -> Dict[str, Any]:
        """Continue at k-1 walk shards after shard ``dead_shard`` is lost.

        Its nodes re-enter the MPGP stream, highest degree first, and go to
        the surviving shards by the partition's own Eq. 14/15 argmax
        (``mpgp.reassign_dead_shard``); the partition-local store is rebuilt
        with the untouched survivors' rows reused
        (``shard_engine.reconfigure_partitions``); the lost shard's resident
        walks are walked again from their roots under their rounds' keys
        and spliced back, bit-identical to what it had walked (vertex keys).
        Walks rooted in the survivors are never touched. The DSGL replica
        count does not change."""
        from repro_torch.core.mpgp import compact_assignment, reassign_dead_shard
        from repro_torch.core.shard_engine import reconfigure_partitions

        self._check_elastic("reconfiguration")
        k = self.walk_shards
        if not 0 <= dead_shard < k:
            raise ValueError(f"dead shard {dead_shard} not in [0, {k})")
        if k <= 1:
            raise ValueError("cannot reconfigure away the last walk shard")
        t0 = time.perf_counter()
        old_asn = np.asarray(self.assignment)
        orphans = old_asn == dead_shard
        new_full = reassign_dead_shard(self.graph, old_asn, dead_shard, num_parts=k,
                                       tau_weight="degree")
        compacted, old_of_new = compact_assignment(new_full, dead_shard, num_parts=k)
        t1 = time.perf_counter()
        eng = reconfigure_partitions(self.graph, old_asn, compacted, k - 1,
                                     old_of_new=old_of_new, key_obj=self.graph)
        self.assignment = compacted
        self.walk_shards = k - 1
        t2 = time.perf_counter()
        rewalk, rounds = self._rewalk_resident(orphans, faults)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        stats = {
            "dead_shard": int(dead_shard),
            "walk_shards": int(self.walk_shards),
            "moved_roots": int(orphans.sum()),
            "moved_frac": float(orphans.mean()),
            "rewalk_walks": int(rewalk),
            "rounds_resident": int(rounds),
            "reused_shards": int(eng["reused_shards"]),
            "rebuilt_shards": int(eng["rebuilt_shards"]),
            "wall_s": float(t3 - t0),
            "phase_s": {"reassign": t1 - t0, "partitions": t2 - t1, "rewalk": t3 - t2},
        }
        self._reconfigs.append(stats)
        obs.span_event("pipeline.reconfig", dead_shard=int(dead_shard),
                       walk_shards=int(self.walk_shards), moved_roots=stats["moved_roots"],
                       rewalk_walks=stats["rewalk_walks"])
        obs.inc("pipeline.reconfigs")
        obs.set_gauge("walk.shards", self.walk_shards)
        with log_context(shard=dead_shard):
            log.info("elastic reconfiguration: %d orphan roots -> %d survivors (%d/%d slices "
                     "reused), %d resident walks migrated in %.3fs", stats["moved_roots"],
                     self.walk_shards, stats["reused_shards"], k - 1, rewalk, stats["wall_s"])
        return stats

    def elastic_rejoin(self, *, faults: FaultInjector = NULL_INJECTOR) -> Dict[str, Any]:
        """Grow back from k to k+1 walk shards when capacity returns. The
        returned shard takes the highest id (survivors' ids never move);
        ``mpgp.rejoin_shard`` gives it a connected donor region of the
        overloaded survivors, and the store is rebuilt with every other
        shard's rows reused. No walk moves: vertex-keyed walks depend on
        neither the shard count nor the assignment, so the next round
        simply dispatches over k+1 shards."""
        from repro_torch.core.mpgp import rejoin_shard
        from repro_torch.core.shard_engine import reconfigure_partitions

        self._check_elastic("re-join")
        k = self.walk_shards
        t0 = time.perf_counter()
        old_asn = np.asarray(self.assignment)
        new_asn, moved = rejoin_shard(self.graph, old_asn, num_parts=k, tau_weight="degree")
        t1 = time.perf_counter()
        eng = reconfigure_partitions(self.graph, old_asn, new_asn, k + 1,
                                     old_of_new=np.concatenate([np.arange(k), [-1]]),
                                     num_shards_old=k, key_obj=self.graph)
        self.assignment = new_asn
        self.walk_shards = k + 1
        t2 = time.perf_counter()
        stats = {
            "kind": "rejoin",
            "walk_shards": int(self.walk_shards),
            "moved_roots": int(moved.sum()),
            "moved_frac": float(moved.mean()),
            "reused_shards": int(eng["reused_shards"]),
            "rebuilt_shards": int(eng["rebuilt_shards"]),
            "wall_s": float(t2 - t0),
            "phase_s": {"rejoin": t1 - t0, "partitions": t2 - t1},
        }
        self._reconfigs.append(stats)
        obs.span_event("pipeline.rejoin", walk_shards=int(self.walk_shards),
                       moved_roots=stats["moved_roots"])
        obs.inc("pipeline.rejoins")
        obs.set_gauge("walk.shards", self.walk_shards)
        log.info("elastic re-join: %d donor roots -> returned shard %d (%d/%d slices reused) "
                 "in %.3fs", stats["moved_roots"], k, stats["reused_shards"], k + 1,
                 stats["wall_s"])
        return stats

    def recover_shard_loss(self, shard_id: int, *,
                           faults: FaultInjector = NULL_INJECTOR) -> Dict[str, Any]:
        """Degraded-mode recovery of one lost walk shard: walk again only the
        resident walks rooted in it, under their rounds' keys, and splice
        them into their slots. With vertex keys they are bit-identical to
        what the shard had walked, so the ring (and ocn) is restored exactly.
        Needs ``WalkSpec.rng_mode == "vertex"``."""
        if self.spec.rng_mode != "vertex":
            raise ValueError("shard-loss recovery requires WalkSpec.rng_mode='vertex'")
        n = len(self.sources)
        if self.assignment is None:
            if shard_id != 0:
                raise ValueError(f"pipeline has no shard assignment (shard {shard_id})")
            mask = np.ones(n, bool)              # one shard: every walk is resident there
        else:
            mask = np.asarray(self.assignment) == shard_id
        t0 = time.perf_counter()
        with log_context(shard=shard_id):
            rewalk, rounds = self._rewalk_resident(mask, faults)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            log.info("shard-loss recovery re-walked %d walks over %d resident rounds",
                     rewalk, rounds)
        return {"shard": int(shard_id), "lost_roots": int(mask.sum()),
                "rewalk_walks": int(rewalk), "rounds_resident": int(rounds),
                "wall_s": float(time.perf_counter() - t0)}

    # --- incremental refresh (core.incremental drives this) ----------------
    def corpus_slots(self) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """(walks, roots, valid): the device ring's walk rows as they lie,
        the host slot -> root map, and the mask of slots ever written.
        Affected-vertex detection reads the ring on the device."""
        return self.ring.walks, self._slot_root, self._slot_root >= 0

    def _rewalk_resident(self, root_mask: np.ndarray,
                         faults: FaultInjector = NULL_INJECTOR) -> Tuple[int, int]:
        """Walk every resident walk rooted in ``root_mask`` again under its
        round's key and splice it into the slot its predecessor holds
        (``ring_replace`` keeps ocn exact). Vertex keys make the subset walks
        the ones a full round on the current graph gives. Fires
        ``refresh_splice`` once per resident round, inside its span, before
        that round's splices land. Returns (walks re-walked, rounds
        resident)."""
        n = len(self.sources)
        slot_ids = np.arange(self.ring.capacity)
        aff_slot = (self._slot_root >= 0) & np.asarray(root_mask)[
            np.maximum(self._slot_root, 0)]
        rounds_resident = np.unique(self._slot_round[aff_slot])
        rewalk_walks = 0
        gv = int(graph_version(self.graph)) if obs.enabled() else None
        for r in rounds_resident:
            with obs.trace_span("refresh.splice", round=int(r), graph_version=gv):
                faults.fire("refresh_splice", int(r))
                sel = aff_slot & (self._slot_round == r)
                roots_r = self._slot_root[sel]
                slot_of = np.full(n, -1, np.int64)
                slot_of[roots_r] = slot_ids[sel]
                for chunk, st in self._run_round(int(r), sources=roots_r, faults=faults):
                    slots = torch.from_numpy(slot_of[chunk]).to(self.device)
                    ring_replace(self.ring, slots, st.path, st.info.L)
                    self._account(st)
                    rewalk_walks += len(chunk)
                obs.inc("refresh.rewalk_walks", int(len(roots_r)))
        return rewalk_walks, int(len(rounds_resident))

    def refresh(self, new_graph, affected_mask: np.ndarray, *,
                fine_tune_steps: Optional[int] = None, fine_tune_frac: float = 0.5,
                fine_tune_lr_scale: float = 0.3, max_extra_rounds: int = 2,
                faults: FaultInjector = NULL_INJECTOR) -> Dict[str, Any]:
        """Absorb a mutated graph: walk again only the affected roots' resident
        walks, splice them in, continue the seeded ΔD gate, fine-tune DSGL in
        place.

        Per retained round the affected roots walk under that round's key
        and their walks replace their predecessors' slots; every other slot
        stays bit-identical. The Eq. 7 controller then continues from the
        run's D_r history: while D moves by more than delta, affected-subset
        rounds append (at most ``max_extra_rounds``, and never a wrap of the
        ring). DSGL fine-tunes over the refreshed ring on a decayed schedule
        of ``fine_tune_frac`` of the original steps at ``fine_tune_lr_scale``
        times the learning rate, with the alias table and the frequency
        order rebuilt from the exact refreshed ocn, through the pipeline's
        CUDA graphs (static buffers: the ring's rows and the negatives are
        gathered into them at each chunk, so no graph holds stale data). The
        MPGP assignment of the base run stays in force. ``faults`` fires
        ``refresh`` at entry and ``refresh_splice`` before each round's
        splices."""
        if self.spec.rng_mode != "vertex":
            raise ValueError("refresh requires WalkSpec.rng_mode='vertex'")
        n = len(self.sources)
        if new_graph.num_nodes != n:
            raise ValueError(f"refresh cannot change the vertex set yet ({new_graph.num_nodes} "
                             f"!= {n}); rebuild with embed_graph")
        if getattr(self.policy, "needs_edge_cm", False) and new_graph.edge_cm is None:
            new_graph = new_graph.with_edge_cm()
        t0 = time.perf_counter()
        gv = int(graph_version(new_graph))
        with obs.trace_span("refresh.enter", graph_version=gv):
            faults.fire("refresh", gv)
        self.graph = new_graph
        self.degrees = new_graph.degrees().cpu().numpy()
        affected = np.nonzero(np.asarray(affected_mask))[0].astype(np.int64)
        cap = self.ring.capacity
        sup0 = self._stats["supersteps"]

        rewalk_walks, retained = self._rewalk_resident(affected_mask, faults)
        t1 = synced_clock(self.device)

        # Seeded ΔD gate: extra subset rounds while D moves.
        hist = list(self.controller.history)
        gate = WalkCountController(delta=self.controller.delta, min_rounds=1,
                                   max_rounds=len(hist) + 1 + max_extra_rounds,
                                   window=self.controller.window, seed_history=hist)
        extra = 0
        r_next = self._rounds_walked
        while len(affected):
            if not gate.update_d(relative_entropy_dpq(self.degrees, self.ring.ocn.cpu().numpy())):
                break
            # An append must fit: a wrap would overwrite unaffected roots'
            # walks and ring_append never subtracts overwritten tokens.
            if self.ring.total + len(affected) > cap:
                break
            self._append(self._run_round(r_next, sources=affected), r_next)
            rewalk_walks += len(affected)
            extra += 1
            r_next += 1
        self._rounds_walked = r_next
        self.controller = gate                  # the next refresh seeds from here
        t2 = synced_clock(self.device)

        ocn_host = self.ring.ocn.cpu().numpy()
        filled = self.ring.num_filled
        ft = (int(fine_tune_steps) if fine_tune_steps is not None
              else max(1, int(fine_tune_frac * self.total_steps)))
        self._ft = (self.global_step, ft, float(self.cfg.lr * fine_tune_lr_scale))
        try:
            table = build_alias_table(ocn_host, self.cfg.neg_power, self.device)
            order = FrequencyOrder.from_ocn(ocn_host) if self.num_shards > 1 else None
            done = 0
            while done < ft:
                step = min(self.steps_per_round, ft - done)
                self._train_slots(0, filled, ocn_host, step, table=table, order=order)
                done += step
        finally:
            self._ft = None
        t3 = synced_clock(self.device)
        obs.inc("refresh.count")
        obs.observe("refresh.s", t3 - t0)
        obs.set_gauge("refresh.affected", int(len(affected)))
        obs.set_gauge("refresh.graph_version", gv)
        return {
            "affected": int(len(affected)),
            "affected_frac": float(len(affected) / max(n, 1)),
            "retained_rounds": int(retained),
            "extra_rounds": int(extra),
            "rewalk_walks": int(rewalk_walks),
            "rewalk_supersteps": int(self._stats["supersteps"] - sup0),
            "fine_tune_steps": int(ft),
            "phase_s": {"rewalk": t1 - t0, "topup": t2 - t1, "finetune": t3 - t2},
        }

    def adopt_graph(self, new_graph) -> None:
        """Adopt a mutated graph without walking or training: later walks see
        it, the ring keeps its stale walks (the detect-only refresh, whose
        caller carries the affected roots as debt)."""
        if new_graph.num_nodes != len(self.sources):
            raise ValueError(f"adopt_graph cannot change the vertex set "
                             f"({new_graph.num_nodes} != {len(self.sources)})")
        if getattr(self.policy, "needs_edge_cm", False) and new_graph.edge_cm is None:
            new_graph = new_graph.with_edge_cm()
        self.graph = new_graph
        self.degrees = new_graph.degrees().cpu().numpy()


def _check_kind(meta: Dict[str, Any], root: str, step: int) -> None:
    if meta.get("kind") != "streaming_pipeline":
        raise ValueError(f"checkpoint at {root} step {step} is not a streaming-pipeline "
                         "snapshot")


def _snapshot_graph(arrays: Dict[str, np.ndarray], device) -> CSRGraph:
    """The snapshot's graph on ``device``, in the port's dtypes."""
    return graph_from_arrays({k[len("graph/"):]: v for k, v in arrays.items()
                              if k.startswith("graph/")}, device)


class DSGLTrainer:
    """Chunked, prefetched loop of ``core.dsgl.train_chunk`` over a
    materialized corpus in rank space.

    Host side: one ``WalkCorpusStream`` per shard replica; a ``Prefetcher``
    thread stacks the next (C, S, G, W, T) chunk while the device trains the
    current one. Device side: the stacked replica matrices stay resident;
    per chunk there is one walk upload, C fused steps (negatives drawn on
    the device from the alias table; on the card one CUDA graph replay) and,
    with S > 1 replicas, one hotness-row exchange. The chunk schedule, the
    chunk keys and the hotness rows are the reference's."""

    def __init__(self, walks_rank: np.ndarray, order, cfg, *, num_shards: int = 1,
                 prefetch_depth: int = 2, device="cuda"):
        from repro_torch.data.pipeline import WalkCorpusStream
        from repro_torch.device import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_shards = num_shards
        self.order = order
        self.chunk = max(cfg.sync_period, 1)
        self.streams = [
            WalkCorpusStream(walks=walks_rank, group_size=cfg.batch_groups,
                             multi_windows=cfg.multi_windows, seed=cfg.seed,
                             shard_id=s, num_shards=num_shards)
            for s in range(num_shards)]
        self.starts, self.ends = order.hotness_blocks()
        self.neg_table = build_alias_table(order.sorted_ocn, cfg.neg_power, self.device)
        self.prefetch_depth = prefetch_depth
        n = len(order.to_rank)
        self.key, *rep_keys = prng.split(prng.PRNGKey(cfg.seed), num_shards + 1)
        reps = [init_embeddings(n, cfg.dim, k, self.device) for k in rep_keys]
        self.phi_in = torch.stack([r[0] for r in reps])
        self.phi_out = torch.stack([r[1] for r in reps])
        self._graphs = ChunkGraphs() if self.device.type == "cuda" else None

    def steps_per_epoch(self) -> int:
        return min(s.steps_per_epoch() for s in self.streams)

    def _lrs(self, global_step: int, count: int, total: int) -> np.ndarray:
        fracs = (global_step + np.arange(count)) / max(total, 1)
        return np.maximum(self.cfg.lr * (1.0 - fracs), self.cfg.min_lr).astype(np.float32)

    def run(self) -> Dict[str, Any]:
        from repro_torch.data.pipeline import Prefetcher, stacked_shard_chunk

        cfg = self.cfg
        spe = self.steps_per_epoch()
        total = cfg.epochs * spe
        rng = np.random.default_rng(cfg.seed)
        # Chunks end at epoch boundaries: each epoch is its own shuffle.
        schedule = [(epoch, step0, min(step0 + self.chunk, spe) - step0)
                    for epoch in range(cfg.epochs) for step0 in range(0, spe, self.chunk)]

        def fetch(chunk_idx: int) -> np.ndarray:
            epoch, step0, count = schedule[chunk_idx % len(schedule)]
            return stacked_shard_chunk(self.streams, epoch, step0, count)

        train = self._graphs.train_chunk if self._graphs is not None else train_chunk
        prefetcher = Prefetcher(fetch, depth=self.prefetch_depth)
        losses: list = []
        t0 = time.perf_counter()
        sync_bytes = 0.0
        do_sync = self.num_shards > 1
        tele = obs.enabled()
        try:
            for epoch, step0, count in schedule:
                t_c = time.perf_counter() if tele else 0.0
                _, chunk_np = prefetcher.next()
                wb = torch.from_numpy(chunk_np).to(self.device)
                rows = (torch.from_numpy(sample_hotness_rows(self.starts, self.ends, rng))
                        if do_sync else None)
                self.key, sub = prng.split(self.key)
                losses.append(train(self.phi_in, self.phi_out, wb, self.neg_table, sub,
                                    self._lrs(epoch * spe + step0, count, total),
                                    cfg.window, cfg.negatives, sync_rows=rows,
                                    sync=do_sync))
                if do_sync:
                    sync_bytes += float(rows.numel() * cfg.dim * 4 * self.num_shards * 2)
                if tele:
                    obs.observe("train.chunk_dispatch.s", time.perf_counter() - t_c)
                    obs.inc("train.steps", count)
        finally:
            prefetcher.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if tele:
            obs.set_gauge("train.steps_per_s", total / max(wall, 1e-9))
            obs.set_gauge("train.sync_bytes", sync_bytes)
        return {
            "steps": total,
            "steps_per_s": total / max(wall, 1e-9),
            "loss": [float(v) for l in losses for v in l.reshape(-1).tolist()],
            "sync_bytes": sync_bytes,
            "wall_s": wall,
        }

    def embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(phi_in, phi_out) in rank space, replica-averaged."""
        if self.num_shards > 1:
            return replica_mean(self.phi_in), replica_mean(self.phi_out)
        return self.phi_in[0], self.phi_out[0]
