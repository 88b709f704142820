"""Batched information-oriented random-walk engine (paper §3.1, Alg. 1).

Every walker is a lane of a batched tensor program and one superstep is
one BSP step: ``propose`` draws a candidate and runs the acceptance test
(rejected lanes keep their node and redraw next superstep), ``absorb``
applies the Theorem 1 / Eq. 13 update, appends the node and tests Eq. 5
termination.

The reference runs the supersteps inside one ``lax.while_loop``; here the
loop is on the host and reads ``any(active)`` back once per superstep — one
device sync each. ``supersteps`` counts exactly the supersteps the
reference's loop runs.

Two information modes: ``incom`` (DistGER) and ``fixed`` (routine walks of
``fixed_len``). RNG is per lane and stateless (``rng_mode="lane"``): lane
i's draws at superstep t depend only on (its block's key, t, i % width),
where a batch's lanes fall into blocks of ``width`` lanes, each with its
own key (``LaneKeys``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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
    info_mode: str = "incom"    # "incom" | "fixed"
    fixed_len: int = 80         # routine walk length (info_mode == "fixed")
    reg_start: int = 1          # L0: start of the regression series
    max_supersteps: int = 0     # 0 => 8 * max_len safety cap
    rng_mode: str = "lane"      # draws keyed by batch position

    def __post_init__(self):
        if self.info_mode not in ("incom", "fixed"):
            raise NotImplementedError(
                f"info_mode={self.info_mode!r}: the port runs 'incom' and 'fixed'")
        if self.rng_mode != "lane":
            raise NotImplementedError(
                f"rng_mode={self.rng_mode!r}: the port runs lane-keyed walks")

    def supersteps_cap(self) -> int:
        return self.max_supersteps or 8 * self.max_len

    def min_test_len(self) -> int:
        """First length at which the R^2 termination test may fire: the
        regression series needs >= 4 points past L0 to be non-degenerate."""
        if self.info_mode == "fixed":
            return self.min_len
        return max(self.min_len, self.reg_start + 3)


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


@dataclasses.dataclass
class WalkerBatchState:
    """State of one batch of walkers."""

    cur: torch.Tensor          # (B,) int64 current node
    prev: torch.Tensor         # (B,) int64 previous node (== cur at start)
    path: torch.Tensor         # (B, max_len) int32, -1 padded
    info: incom.InfoState      # (B,) scalars
    active: torch.Tensor       # (B,) bool
    keys: LaneKeys             # lane i's draws derive from (its block key, t, i % width)
    supersteps: int = 0
    accepts: torch.Tensor = None   # () int64
    rejects: torch.Tensor = None   # () int64


def init_batch(sources: torch.Tensor, keys: LaneKeys, spec: WalkSpec) -> WalkerBatchState:
    b, dev = sources.shape[0], sources.device
    path = torch.full((b, spec.max_len), -1, dtype=torch.int32, device=dev)
    path[:, 0] = sources.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return WalkerBatchState(
        cur=sources.to(torch.int64), prev=sources.to(torch.int64), path=path,
        info=incom.InfoState.init(b, dev),
        active=torch.ones(b, dtype=torch.bool, device=dev),
        keys=keys, accepts=zero, rejects=zero)


def step_uniforms(keys: LaneKeys, superstep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_cand, u_accept), each (B,): what the reference's ``step_uniforms``
    draws for lane i % width under block key i // width — split(fold_in(key,
    superstep)) gives (k1, k2) and the lane reads counter i % width of each.
    The block keys derive on the device, then one threefry pass draws both."""
    k0, k1 = keys.step_keys(superstep)                         # (2, blocks)
    u = prng.uniform_at(k0[:, keys.block], k1[:, keys.block], keys.counter)
    return u[0], u[1]


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


def absorb(spec: WalkSpec, info: incom.InfoState, path: torch.Tensor,
           cand: torch.Tensor, proc: torch.Tensor):
    """Apply one accepted step on ``proc`` lanes. Returns (info', path',
    done_now)."""
    info_acc, new_path = incom.accept_update(info, path, cand, spec.reg_start,
                                             mask=proc)
    new_info = info_acc.where(proc, info)
    l_new = new_info.L
    if spec.info_mode == "fixed":
        done_now = proc & (l_new >= float(spec.fixed_len))
    else:
        r2 = incom.r_squared(new_info)
        mu = float(np.float32(spec.mu))     # the reference compares in float32
        done_now = proc & (l_new >= float(spec.min_test_len())) & (r2 < mu)
    done_now = done_now | (proc & (l_new >= float(spec.max_len)))
    return new_info, new_path, done_now


def _superstep(graph: CSRGraph, policy: Policy, spec: WalkSpec,
               st: WalkerBatchState) -> WalkerBatchState:
    u1, u2 = step_uniforms(st.keys, st.supersteps)
    cand, _, accept_raw, has_nbrs = propose(graph, policy, st.cur, st.prev, u1, u2)
    accept = st.active & accept_raw
    dead_end = st.active & ~has_nbrs     # no neighbours: terminate now
    new_info, new_path, done_now = absorb(spec, st.info, st.path, cand, accept)
    return WalkerBatchState(
        cur=torch.where(accept, cand, st.cur),
        prev=torch.where(accept, st.cur, st.prev),
        path=new_path,
        info=new_info,
        active=st.active & ~(done_now | dead_end),
        keys=st.keys,
        supersteps=st.supersteps + 1,
        accepts=st.accepts + accept.sum(),
        rejects=st.rejects + (st.active & has_nbrs & ~accept_raw).sum(),
    )


def run_walk_batch(graph: CSRGraph, sources: torch.Tensor, keys: LaneKeys,
                   policy: Policy, spec: WalkSpec) -> WalkerBatchState:
    """Run one walk per source until every lane terminates (or the cap).
    ``supersteps`` counts the supersteps of this batch, the most any of its
    blocks needs."""
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
        "mean_len": float(st.info.L.mean()),
    }
