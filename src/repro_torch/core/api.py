"""Embedding API (paper §6.6 "Generality of DistGER").

DeepWalk / node2vec / HuGE all run through the same sampler, each with its
routine configuration (fixed L, r) or DistGER's information-centric
termination (R^2 < mu walk length + Delta D <= delta walk count).
``embed_graph`` is the one-call entry point: sample -> learn -> embeddings;
``refresh_embedding`` absorbs edge churn into a live embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.corpus import Corpus, generate_corpus
from repro_torch.core.transition import make_policy
from repro_torch.core.walker import WalkSpec
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    method: str = "huge"           # huge | deepwalk | node2vec | huge_plus
    info_termination: bool = True  # DistGER info-centric L and r
    fixed_len: int = 80            # routine config (when info_termination=False)
    fixed_rounds: int = 10
    max_len: int = 100
    min_len: int = 20
    mu: float = 0.995
    reg_start: int = 16
    delta: float = 1e-3
    d_window: int = 3              # Eq. 7 gate: windowed-mean ΔD (1 = raw)
    dim: int = 128
    window: int = 10
    negatives: int = 5
    epochs: int = 1
    lr: float = 0.025
    multi_windows: int = 2
    seed: int = 0
    p: float = 1.0                 # node2vec return parameter
    q: float = 1.0                 # node2vec in-out parameter
    rng_mode: str = "lane"         # walk RNG: "lane" (batch position) or "vertex" (source id)


def make_walk_plan(cfg: EmbedConfig) -> Tuple[object, WalkSpec, Dict]:
    """Resolve (policy, spec, round kwargs) for a method + termination mode."""
    name = "huge" if cfg.method in ("huge", "huge_plus") else cfg.method
    policy = make_policy(name, p=cfg.p, q=cfg.q)
    if cfg.info_termination:
        spec = WalkSpec(max_len=cfg.max_len, min_len=cfg.min_len,
                        mu=cfg.mu, info_mode="incom", reg_start=cfg.reg_start,
                        rng_mode=cfg.rng_mode)
        rounds = dict(delta=cfg.delta, min_rounds=2, max_rounds=20,
                      window=cfg.d_window)
    else:
        spec = WalkSpec(max_len=cfg.fixed_len, info_mode="fixed",
                        fixed_len=cfg.fixed_len, rng_mode=cfg.rng_mode)
        rounds = dict(delta=-1.0, min_rounds=cfg.fixed_rounds,
                      max_rounds=cfg.fixed_rounds)
    return policy, spec, rounds


def dsgl_config(cfg: EmbedConfig):
    """The DSGL configuration ``embed_graph`` trains with under ``cfg``."""
    from repro_torch.core.dsgl import DSGLConfig

    return DSGLConfig(dim=cfg.dim, window=cfg.window, negatives=cfg.negatives,
                      epochs=cfg.epochs, lr=cfg.lr, multi_windows=cfg.multi_windows,
                      seed=cfg.seed)


def sample_corpus(graph, cfg: EmbedConfig, part: Optional[np.ndarray] = None, *,
                  device="cuda") -> Corpus:
    """Rounds of walks until the ΔD gate stops them, as a host ``Corpus``:
    on the dense engine, or with a partition ``part`` on the
    partition-sharded engine (the same walks, with their messages counted)."""
    policy, spec, rounds = make_walk_plan(cfg)
    return generate_corpus(graph.to(device), policy=policy, spec=spec,
                           seed=cfg.seed, part=part, **rounds)


@dataclasses.dataclass
class EmbedState:
    """A live embedding: the streaming pipeline and the delta overlay /
    refresh logic around it, which ``refresh_embedding`` keeps current
    across edge-churn batches."""

    refresher: object           # core.incremental.IncrementalRefresh
    cfg: EmbedConfig
    num_shards: int

    @property
    def graph(self):
        return self.refresher.pipeline.graph

    def embeddings(self):
        return self.refresher.embeddings()


def embed_graph(
    graph,
    cfg: EmbedConfig = EmbedConfig(),
    *,
    num_shards: int = 1,
    return_corpus: bool = False,
    return_stats: bool = False,
    streaming: bool = True,
    updates=None,
    return_state: bool = False,
    device="cuda",
):
    """partition -> info-oriented walks -> DSGL -> embeddings, on ``device``.

    With ``num_shards`` > 1 the graph is partitioned by MPGP first, the
    walks run on the partition-sharded engine over that many shards
    (``core.shard_engine``, which measures the InCoM messages between
    them), and DSGL trains that many replicas under the hotness-block sync.
    The default path
    is the streaming pipeline (``runtime.trainer.StreamingEmbedPipeline``):
    finished walk rounds append into a device-resident corpus ring and DSGL
    training consumes ring slots directly. Each round walks from every node
    in batches of up to ``walker.MAX_LANES`` lanes (one batch on every
    preset up to or-sim). ``streaming=False`` is the two-phase path: sample
    the whole corpus, then ``dsgl.train_dsgl`` in frequency-rank space.

    Dynamic graphs: ``return_state=True`` also returns an ``EmbedState``
    that ``refresh_embedding`` absorbs edge churn into (the walks are then
    vertex-keyed, so a subset of a round walks again as it walked);
    ``updates=EdgeBatch(...)`` embeds the graph and refreshes it with the
    batch at once. Both need the streaming pipeline.

    Returns (phi_in, phi_out) as tensors on ``device`` in node-id space
    (replica-averaged), plus the host ``Corpus`` if ``return_corpus``, on
    the streaming path the run's summary if ``return_stats`` (rounds,
    steps, chunks, syncs and their bytes, walk statistics with the
    messages' count and bytes, measured and analytic, at k > 1, the Cm and
    partition seconds ``cm_s`` and ``part_s``, the partition's locality,
    balance and per-part node counts, and its ``assignment``, node ->
    shard), and the ``EmbedState`` if
    ``return_state``, in that order."""
    import time

    import torch

    from repro_torch.core.corpus import FrequencyOrder
    from repro_torch.core.dsgl import train_dsgl
    from repro_torch.core.mpgp import mpgp_partition
    from repro_torch.runtime.trainer import StreamingEmbedPipeline

    incremental = updates is not None or return_state
    if incremental and not streaming:
        raise ValueError("updates= and return_state= need the streaming pipeline "
                         "(streaming=True); the two-phase path keeps no state to refresh")
    if incremental and cfg.rng_mode != "vertex":
        cfg = dataclasses.replace(cfg, rng_mode="vertex")
    dev = resolve_device(device)
    graph = graph.to(dev)
    policy, spec, rounds = make_walk_plan(cfg)
    part, summary = None, {"cm_s": 0.0}
    if num_shards > 1:
        if graph.edge_cm is None:                # PS2's counts, and HuGE's
            t0 = time.perf_counter()
            graph = graph.with_edge_cm()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            summary["cm_s"] = time.perf_counter() - t0
        result = mpgp_partition(graph, num_shards)
        part = result.assignment
        summary.update(part_s=result.seconds, locality=result.locality,
                       balance=result.balance, part_counts=result.counts().tolist(),
                       assignment=part)
    dsgl_cfg = dsgl_config(cfg)

    if not streaming:
        if return_stats:
            raise ValueError("return_stats needs the streaming pipeline")
        corpus = sample_corpus(graph, cfg, part, device=dev)
        order = FrequencyOrder.from_ocn(corpus.ocn)
        phi_in, phi_out = train_dsgl(corpus, order, dsgl_cfg, num_shards=num_shards,
                                     device=dev)
        to_rank = torch.as_tensor(order.to_rank.astype(np.int64), device=dev)
        out = (phi_in[to_rank], phi_out[to_rank])        # back to node-id space
        return out + (corpus,) if return_corpus else out

    pipe = StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl_cfg,
                                  assignment=part, num_shards=num_shards)
    run = pipe.run()
    run["cm_s"] += summary.pop("cm_s")
    summary.update({k: v for k, v in run.items() if k not in ("phi_in", "phi_out", "ring")})
    state = None
    if incremental:
        from repro_torch.core.incremental import IncrementalRefresh

        state = EmbedState(refresher=IncrementalRefresh(pipe), cfg=cfg, num_shards=num_shards)
        if updates is not None:
            state.refresher.apply_updates(updates)
            state.refresher.refresh()
    out = pipe.embeddings()
    if incremental:                 # a refresh trains phi in place: hand out copies
        out = tuple(t.clone() for t in out)
    if return_corpus:
        out = out + (pipe.corpus(),)
    if return_stats:
        out = out + (summary,)
    if return_state:
        out = out + (state,)
    return out


def refresh_embedding(state: EmbedState, updates, *, detect: Optional[str] = None,
                      **refresh_kwargs):
    """Absorb an ``EdgeBatch`` into a live embedding, on the device the
    embedding lives on: mutate -> detect (from the corpus) -> walk again
    only the affected vertices -> fine-tune DSGL in place. Returns (phi_in,
    phi_out, stats), ``stats`` a ``core.incremental.RefreshStats``. Keyword
    arguments (``fine_tune_frac``, ``max_extra_rounds``, ``mode``, ...) go
    to the refresh; ``detect`` ("traversal" or "paranoid") overrides the
    detection mode for this call only."""
    prev_detect = state.refresher.detect
    if detect is not None:
        state.refresher.detect = detect
    try:
        state.refresher.apply_updates(updates)
        stats = state.refresher.refresh(**refresh_kwargs)
    finally:
        state.refresher.detect = prev_detect
    phi_in, phi_out = (t.clone() for t in state.refresher.embeddings())
    return phi_in, phi_out, stats
