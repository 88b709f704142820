"""Batched information-oriented random-walk engine (paper §3.1, Alg. 1).

Every walker is a lane of a batched tensor program and one superstep is
one BSP step: ``propose`` draws a candidate and runs the acceptance test
(rejected lanes keep their node and redraw next superstep), ``absorb``
applies the Theorem 1 / Eq. 13 update, appends the node and tests Eq. 5
termination. The partition-sharded engine (``core.shard_engine``) runs the
same two phases, ``propose`` where the walker resides and ``absorb`` where
the accepted node lives.

The reference runs the supersteps inside one ``lax.while_loop``; here the
loop is on the host and reads ``any(active)`` back once per superstep — one
device sync each. ``supersteps`` counts exactly the supersteps the
reference's loop runs.

Three information modes: ``incom`` (DistGER: O(1) updates, optionally with
R^2 over a ring of the last ``reg_window`` entropies), ``fullpath`` (the
HuGE-D baseline: H recomputed from the path and R^2 over the stored
H-series at every step) and ``fixed`` (routine walks of ``fixed_len``).
RNG is per lane and stateless. Under ``rng_mode="lane"`` lane i's draws at
superstep t depend only on (its block's key, t, i % width), where a
batch's lanes fall into blocks of ``width`` lanes, each with its own key
(``LaneKeys``). Under ``rng_mode="vertex"`` they depend only on (the round
key, t, lane i's source vertex) (``VertexKeys``): a walk is then the same
in any batch that holds its source, which lets the incremental refresh
re-walk a subset of sources and reproduce a full round's walks. Either way
walks are the same on one shard or k.

With a partition ``part``, ``run_walk_batch`` runs the batch on the
partition-sharded engine, whose ``msg_count`` / ``msg_bytes`` are measured
from the messages it exchanges between shards (80-byte InCoM messages,
24 + 8L bytes for fullpath), with the analytic figure beside them
(``msg_bytes_analytic``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import incom
from repro_torch.core.transition import Policy, node_degrees
from repro_torch.graph.csr import CSRGraph

# Most lanes in one walk batch. A batch's state takes about 2 KB per lane at
# max_len=100 (a whole yt-sim run, 1.14 M lanes in one batch, peaks at
# 3.9 GiB on an 80 GB H100), so every preset up to or-sim walks a round as
# one batch.
MAX_LANES = 1 << 22
# The reference pipeline's chunk width: it walks a round in chunks of this
# many sources (``walker_batch`` of ``repro.runtime.trainer``'s pipeline and
# of ``repro.core.corpus.generate_corpus``), each chunk under its own key,
# lane j of a chunk drawing counter j. The port walks up to MAX_LANES lanes
# at once and gives lane i the key of the reference's chunk i // REF_CHUNK
# and counter i % REF_CHUNK, so its walks are the reference's, bit for bit,
# at any |V|. A constant of the reference's stream, not a knob.
REF_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class WalkSpec:
    max_len: int = 100          # path buffer capacity (hard cap)
    min_len: int = 8            # don't test termination before this length
    mu: float = 0.995           # Eq. 5 termination threshold (R^2 < mu)
    info_mode: str = "incom"    # "incom" | "fullpath" | "fixed"
    fixed_len: int = 80         # routine walk length (info_mode == "fixed")
    reg_start: int = 1          # L0: start of the regression series
    reg_window: int = 0         # > 0: R^2 over the last K points (incom.windowed_r_squared)
    max_supersteps: int = 0     # 0 => 8 * max_len safety cap
    rng_mode: str = "lane"      # "lane": draws keyed by batch position; "vertex": by source

    def __post_init__(self):
        if self.info_mode not in ("incom", "fullpath", "fixed"):
            raise ValueError(f"unknown info_mode {self.info_mode!r}")
        if self.rng_mode not in ("lane", "vertex"):
            raise ValueError(f"unknown rng_mode {self.rng_mode!r}")

    def supersteps_cap(self) -> int:
        return self.max_supersteps or 8 * self.max_len

    def min_test_len(self) -> int:
        """First length at which the R^2 termination test may fire: the
        regression series needs >= 4 points past L0 to be non-degenerate."""
        if self.info_mode == "fixed":
            return self.min_len
        if self.reg_window:
            return max(self.min_len, 4)
        return max(self.min_len, self.reg_start + 3)

    def h_len(self) -> int:
        """Width of a walker's H-series: the whole walk's in fullpath mode."""
        return self.max_len if self.info_mode == "fullpath" else 1

    def ring_len(self) -> int:
        return max(self.reg_window, 1)


# Supersteps whose block keys derive together, in one device pass: the
# key schedule of a superstep is three threefry passes over the blocks, a
# few hundred tiny device ops, so it runs once per this many supersteps.
STEP_KEY_WINDOW = 64


class LaneKeys:
    """The keys of one walk batch of ``lanes`` lanes: lane i draws what a
    batch keyed ``(k0[i // width], k1[i // width])`` draws at its lane
    ``i % width``."""

    def __init__(self, k0: torch.Tensor, k1: torch.Tensor, width: int, lanes: int):
        self.k0, self.k1, self.width = k0, k1, int(width)   # (blocks,) int64 key words
        lane = torch.arange(lanes, dtype=torch.int64, device=k0.device)
        self.block = lane // self.width
        self.counter = lane - self.block * self.width
        self._window = (None, None)          # (first superstep, its step keys)

    @staticmethod
    def of(keys, width: int, lanes: int, device) -> "LaneKeys":
        k = torch.tensor(list(keys), dtype=torch.int64).reshape(-1, 2).to(device)
        return LaneKeys(k[:, 0], k[:, 1], width, lanes)

    @staticmethod
    def for_round(round_key: prng.Key, first: int, b: int, device) -> "LaneKeys":
        """Lanes ``first .. first + b`` of a round as the reference pipeline
        keys them: chunk ``start`` under ``fold_in(round_key, start)``,
        computed on the device for every block at once."""
        if first % REF_CHUNK:
            raise ValueError(f"a batch starts on a {REF_CHUNK}-lane block, not {first}")
        starts = torch.arange(first, first + b, REF_CHUNK, dtype=torch.int64,
                              device=device)
        k0, k1 = prng.fold_in_tensor(round_key[0], round_key[1], starts)
        return LaneKeys(k0, k1, REF_CHUNK, b)

    def step_keys(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """split(fold_in(block key, t)) for every block: (k0, k1), each
        (2, blocks), row 0 the candidate draw's key and row 1 the accept
        draw's. Derived for STEP_KEY_WINDOW supersteps at a time."""
        t0 = t - t % STEP_KEY_WINDOW
        if self._window[0] != t0:
            ts = torch.arange(t0, t0 + STEP_KEY_WINDOW, dtype=torch.int64,
                              device=self.k0.device)[:, None]
            s0, s1 = prng.fold_in_tensor(self.k0[None], self.k1[None], ts)
            self._window = (t0, prng.split_tensor(s0, s1))     # each (2, T, blocks)
        k0, k1 = self._window[1]
        return k0[:, t - t0], k1[:, t - t0]

    def uniforms(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(u_cand, u_accept), each (B,): what the reference's
        ``step_uniforms`` draws for lane i % width under block key i // width
        (split(fold_in(key, t)) gives (k1, k2), and the lane reads counter
        i % width of each). The block keys derive on the device, then one
        threefry pass draws both."""
        k0, k1 = self.step_keys(t)                              # (2, blocks)
        u = prng.uniform_at(k0[:, self.block], k1[:, self.block], self.counter)
        return u[0], u[1]


class VertexKeys:
    """The keys of one vertex-keyed walk batch (``rng_mode="vertex"``): at
    superstep t, with (k1, k2) = split(fold_in(round_key, t)), lane i draws
    uniform(fold_in(k1, source[i])) and uniform(fold_in(k2, source[i])), as
    the reference's ``make_uniform_fn`` does. A draw depends on (round key,
    t, source) only, not on where the source sits in the batch."""

    def __init__(self, round_key: prng.Key, sources: torch.Tensor):
        # The round key as a batch of one block: its step keys derive on the
        # device, STEP_KEY_WINDOW supersteps at a time.
        self.steps = LaneKeys.of([round_key], 1, 1, sources.device)
        self.src = sources.to(torch.int64)[None, :]              # (1, B)

    def uniforms(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(u_cand, u_accept), each (B,): two threefry passes over (2, B)
        fold each lane's source into the step's two keys and draw counter 0
        of the folded key (a scalar ``uniform``)."""
        k0, k1 = self.steps.step_keys(t)                         # (2, 1) each
        f0, f1 = prng.fold_in_tensor(k0, k1, self.src)           # (2, B)
        u = prng.uniform_at(f0, f1, 0)
        return u[0], u[1]


Keys = Union[LaneKeys, VertexKeys]


@dataclasses.dataclass
class WalkerBatchState:
    """State of one batch of walkers."""

    cur: torch.Tensor          # (B,) int64 current node
    prev: torch.Tensor         # (B,) int64 previous node (== cur at start)
    path: torch.Tensor         # (B, max_len) int32, -1 padded
    info: incom.InfoState      # (B,) scalars
    h_series: torch.Tensor     # (B, max_len) float32 in fullpath mode, else (B, 1)
    hring: torch.Tensor        # (B, K) float32 ring of recent H (reg_window mode)
    active: torch.Tensor       # (B,) bool
    keys: Keys                 # the lanes' draws (LaneKeys or VertexKeys)
    supersteps: int = 0
    accepts: torch.Tensor = None   # () int64
    rejects: torch.Tensor = None   # () int64
    msg_count: torch.Tensor = None           # () int64: cross-shard hand-offs
    msg_bytes: torch.Tensor = None           # () float32: their bytes, measured
    msg_bytes_analytic: torch.Tensor = None  # () float32: Example 1's closed form


def init_batch(sources: torch.Tensor, keys: Keys, spec: WalkSpec) -> WalkerBatchState:
    b, dev = sources.shape[0], sources.device
    path = torch.full((b, spec.max_len), -1, dtype=torch.int32, device=dev)
    path[:, 0] = sources.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    return WalkerBatchState(
        cur=sources.to(torch.int64), prev=sources.to(torch.int64), path=path,
        info=incom.InfoState.init(b, dev),
        h_series=torch.zeros(b, spec.h_len(), dtype=torch.float32, device=dev),
        hring=torch.zeros(b, spec.ring_len(), dtype=torch.float32, device=dev),
        active=torch.ones(b, dtype=torch.bool, device=dev),
        keys=keys, accepts=zero, rejects=zero,
        msg_count=zero, msg_bytes=zero_f, msg_bytes_analytic=zero_f)


def propose(graph: CSRGraph, policy: Policy, cur, prev, u1, u2):
    """Candidate draw + walking-backtracking acceptance, per lane.

    Returns (cand, eidx, accept_raw, has_nbrs); ``accept_raw`` already
    includes ``has_nbrs``."""
    deg = node_degrees(graph, cur)
    has_nbrs = deg > 0
    j = torch.minimum((u1 * deg).to(torch.int64),
                      (deg.to(torch.int64) - 1).clamp_min(0))
    eidx = (graph.indptr[cur] + j).clamp(0, graph.indices.shape[0] - 1)
    cand = graph.indices[eidx]
    p_acc = policy.accept_prob(graph, prev, cur, cand, eidx)
    return cand, eidx, has_nbrs & (u2 < p_acc), has_nbrs


def _fullpath_entropy(path: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """H(W^L) recomputed from the path, O(max_len^2) per lane:
    H = -(1/L) sum_{i<L} log2(n(path_i) / L)."""
    pos = torch.arange(path.shape[1], device=path.device)
    mask = pos[None, :] < length[:, None]                       # (B, max_len)
    eq = (path[:, :, None] == path[:, None, :]) & mask[:, None, :] & mask[:, :, None]
    n_i = eq.sum(-1).to(torch.float32)
    lf = torch.clamp_min(length.to(torch.float32), 1.0)[:, None]
    term = torch.where(mask, torch.log2(torch.clamp_min(n_i, 1.0) / lf), 0.0)
    return -term.sum(-1) / lf[:, 0]


def _fullpath_r2(h_series: torch.Tensor, length: torch.Tensor, window: int = 0,
                 start: int = 1) -> torch.Tensor:
    """Pearson R^2 over the stored prefix-entropy series, O(L) per step;
    ``window`` > 0 keeps the last ``window`` points, ``start`` = L0 drops
    the points with L < L0."""
    pos = torch.arange(h_series.shape[1], dtype=torch.float32, device=h_series.device)
    l_series = pos[None, :] + 1.0
    in_prefix = pos[None, :] < length[:, None]
    if window:
        in_prefix = in_prefix & (pos[None, :] >= length[:, None] - window)
    if start > 1:
        in_prefix = in_prefix & (l_series >= float(start))
    mask = in_prefix.to(torch.float32)
    cnt = torch.clamp_min(mask.sum(-1), 1.0)
    eh = (h_series * mask).sum(-1) / cnt
    el = (l_series * mask).sum(-1) / cnt
    ehl = (h_series * l_series * mask).sum(-1) / cnt
    eh2 = (h_series * h_series * mask).sum(-1) / cnt
    el2 = (l_series * l_series * mask).sum(-1) / cnt
    cov = ehl - eh * el
    vh = torch.clamp_min(eh2 - eh * eh, 0.0)
    vl = torch.clamp_min(el2 - el * el, 0.0)
    denom = vh * vl
    return torch.where(denom > 1e-12, cov * cov / torch.clamp_min(denom, 1e-12), 0.0)


def absorb(spec: WalkSpec, info: incom.InfoState, path: torch.Tensor,
           h_series: torch.Tensor, hring: torch.Tensor, cand: torch.Tensor,
           proc: torch.Tensor):
    """Apply one accepted step on ``proc`` lanes against the local buffers.

    ``path`` is the whole walk on one shard and the owner's fragment in the
    sharded engine: n(v) is the same over either, since every visit to v
    is appended where v lives. The append at position L is idempotent, so
    fullpath callers that appended before shipping the walk reuse it.
    Returns (info', path', h_series', hring', done_now)."""
    info_acc, new_path = incom.accept_update(info, path, cand, spec.reg_start,
                                             mask=proc)
    new_info = info_acc.where(proc, info)
    l_new = new_info.L
    if spec.info_mode == "fullpath":
        length = l_new.to(torch.int64)
        h_full = _fullpath_entropy(new_path, length)
        idx = (length - 1).clamp(0, spec.max_len - 1)
        hpos = torch.arange(h_series.shape[1], device=h_series.device)[None, :]
        h_series = torch.where(proc[:, None] & (hpos == idx[:, None]), h_full[:, None],
                               h_series)
        r2 = _fullpath_r2(h_series, length, spec.reg_window, spec.reg_start)
        # The recomputed H equals the incremental one; its cost is the point.
        new_info = dataclasses.replace(new_info, H=torch.where(proc, h_full, new_info.H))
    elif spec.reg_window:
        k = hring.shape[1]
        slot = torch.remainder(l_new.to(torch.int64) - 1, k)
        rpos = torch.arange(k, device=hring.device)[None, :]
        hring = torch.where(proc[:, None] & (rpos == slot[:, None]), new_info.H[:, None],
                            hring)
        r2 = incom.windowed_r_squared(hring, l_new, spec.reg_window)
    else:
        r2 = incom.r_squared(new_info)
    if spec.info_mode == "fixed":
        done_now = proc & (l_new >= float(spec.fixed_len))
    else:
        mu = float(np.float32(spec.mu))     # the reference compares in float32
        done_now = proc & (l_new >= float(spec.min_test_len())) & (r2 < mu)
    done_now = done_now | (proc & (l_new >= float(spec.max_len)))
    return new_info, new_path, h_series, hring, done_now


def _superstep(graph: CSRGraph, policy: Policy, spec: WalkSpec,
               st: WalkerBatchState) -> WalkerBatchState:
    u1, u2 = st.keys.uniforms(st.supersteps)
    cand, _, accept_raw, has_nbrs = propose(graph, policy, st.cur, st.prev, u1, u2)
    accept = st.active & accept_raw
    dead_end = st.active & ~has_nbrs     # no neighbours: terminate now
    new_info, new_path, h_series, hring, done_now = absorb(
        spec, st.info, st.path, st.h_series, st.hring, cand, accept)
    return dataclasses.replace(
        st,
        cur=torch.where(accept, cand, st.cur),
        prev=torch.where(accept, st.cur, st.prev),
        path=new_path,
        info=new_info,
        h_series=h_series,
        hring=hring,
        active=st.active & ~(done_now | dead_end),
        supersteps=st.supersteps + 1,
        accepts=st.accepts + accept.sum(),
        rejects=st.rejects + (st.active & has_nbrs & ~accept_raw).sum(),
    )


def run_walk_batch(graph: CSRGraph, sources: torch.Tensor, keys: Keys,
                   policy: Policy, spec: WalkSpec, part=None,
                   num_shards: Optional[int] = None, **shard_kwargs) -> WalkerBatchState:
    """Run one walk per source until every lane terminates (or the cap).
    ``supersteps`` counts the supersteps of this batch, the most any of its
    blocks needs.

    Without ``part`` this is the dense single-shard engine. With ``part``
    (node -> shard) the batch runs on the partition-sharded BSP engine,
    ``num_shards`` shards (max(part) + 1 if not given), and the returned
    message counts are measured from its exchanges. The walks are the same
    either way. Further keyword arguments (``engine``, ``pool_factor``,
    ``exchange_cap``, ...) go to ``shard_engine.run_walk_sharded``."""
    if part is not None:
        from repro_torch.core.shard_engine import run_walk_sharded
        part = np.asarray(part)
        if num_shards is None:
            num_shards = int(part.max()) + 1
        return run_walk_sharded(graph, sources, keys, policy, spec, part, num_shards,
                                **shard_kwargs)
    st = init_batch(sources, keys, spec)
    cap = spec.supersteps_cap()
    while st.supersteps < cap and bool(st.active.any()):   # host sync
        st = _superstep(graph, policy, spec, st)
    return st


def batch_stats(st: WalkerBatchState) -> Dict[str, float]:
    return {
        "supersteps": st.supersteps,
        "accepts": int(st.accepts),
        "rejects": int(st.rejects),
        "msg_count": int(st.msg_count),
        "msg_bytes": float(st.msg_bytes),
        "msg_bytes_analytic": float(st.msg_bytes_analytic),
        "mean_len": float(st.info.L.mean()),
    }
