"""Embedding API (paper §6.6 "Generality of DistGER").

DeepWalk / node2vec / HuGE all run through the same sampler, each with its
routine configuration (fixed L, r) or DistGER's information-centric
termination (R^2 < mu walk length + Delta D <= delta walk count).
``embed_graph`` is the one-call entry point: sample -> learn -> embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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
    rng_mode: str = "lane"         # walk RNG keying (the port runs "lane")


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


def sample_corpus(graph, cfg: EmbedConfig, *, device="cuda") -> Corpus:
    policy, spec, rounds = make_walk_plan(cfg)
    return generate_corpus(graph.to(device), policy=policy, spec=spec,
                           seed=cfg.seed, **rounds)


def embed_graph(
    graph,
    cfg: EmbedConfig = EmbedConfig(),
    *,
    num_shards: int = 1,
    return_corpus: bool = False,
    return_stats: bool = False,
    device="cuda",
):
    """info-oriented walks -> streamed DSGL -> embeddings, on ``device``.

    The streaming pipeline (``runtime.trainer.StreamingEmbedPipeline``):
    finished walk rounds append into a device-resident corpus ring and
    DSGL training consumes ring slots directly. Each round walks from every
    node in batches of up to ``walker.MAX_LANES`` lanes (one batch on every
    preset up to or-sim). Returns (phi_in, phi_out) as tensors on ``device`` in
    node-id space, plus the host ``Corpus`` if ``return_corpus`` and the
    run's summary (rounds, steps, walk statistics, Cm time) if
    ``return_stats``.
    """
    from repro_torch.core.dsgl import DSGLConfig
    from repro_torch.runtime.trainer import StreamingEmbedPipeline

    graph = graph.to(resolve_device(device))
    dsgl_cfg = DSGLConfig(
        dim=cfg.dim, window=cfg.window, negatives=cfg.negatives,
        epochs=cfg.epochs, lr=cfg.lr, multi_windows=cfg.multi_windows,
        seed=cfg.seed,
    )
    policy, spec, rounds = make_walk_plan(cfg)
    pipe = StreamingEmbedPipeline(graph, policy, spec, rounds, dsgl_cfg,
                                  num_shards=num_shards)
    summary = pipe.run()
    out = pipe.embeddings()
    if return_corpus:
        out = out + (pipe.corpus(),)
    if return_stats:
        out = out + ({k: v for k, v in summary.items()
                      if k not in ("phi_in", "phi_out", "ring")},)
    return out
