"""DSGL — distributed Skip-Gram learning (paper §4).

Improvement-I (global matrices + local buffers): each training lifetime
gathers the rows it will touch into local buffers, performs every update
there (``kernels.sgns``: the CUDA kernel on the card, the plain version on
the CPU) and writes the deltas back once at the end.

Improvement-II (multi-window shared negatives): ``multi_windows`` walks
train together per lifetime; their context windows share one negative set
per position, and each walk's target is an extra negative for the others.

The embedding matrices are (S, N, d) stacks of S replicas and are updated
in place. Negatives are drawn on the device from a Vose alias table, for a
whole chunk of lifetimes at once. Duplicate buffer rows of one batch are
AVERAGED on write-back (``_scatter_average``); the write-back is
``index_add_``, whose float sums on CUDA land in a nondeterministic order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.sgns import ops as sgns_ops


@dataclasses.dataclass(frozen=True)
class DSGLConfig:
    dim: int = 128
    window: int = 10            # w — context half-width
    negatives: int = 5          # K — shared negative samples per position
    multi_windows: int = 2      # W — walks trained together per lane
    batch_groups: int = 64      # G — lifetimes per step
    epochs: int = 1
    lr: float = 0.025
    min_lr: float = 1e-4
    neg_power: float = 0.75     # unigram^0.75 negative-sampling distribution
    sync_period: int = 50       # lifetimes per dispatched chunk
    seed: int = 0


def init_embeddings(num_nodes: int, dim: int, key: prng.Key,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """word2vec convention: phi_in ~ U(-0.5/d, 0.5/d), phi_out = 0."""
    phi_in = (prng.uniform(key, (num_nodes, dim), device) - 0.5) / dim
    phi_out = torch.zeros(num_nodes, dim, dtype=torch.float32, device=device)
    return phi_in, phi_out


# ---------------------------------------------------------------------------
# Negative sampling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AliasTable:
    """Vose alias table over the unigram^power distribution: O(1) draws.

    ``prob[i]`` is the acceptance probability of slot i, ``alias[i]`` the
    fallback id."""

    prob: torch.Tensor    # (n,) f32
    alias: torch.Tensor   # (n,) int64


def build_alias_table(ocn_sorted: np.ndarray, power: float, device) -> AliasTable:
    """Vose's algorithm over the unigram^power weights (host, build-once).

    The reference's loop in float64, on Python lists for speed: the same
    operations in the same order, so the table is bit-identical."""
    w = np.asarray(ocn_sorted, dtype=np.float64) ** power
    if w.sum() == 0:
        w = np.ones_like(w)
    n = len(w)
    scaled = (w / w.sum() * n).tolist()
    prob = [1.0] * n
    alias = list(range(n))
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:   # numerical leftovers: accept always
        prob[i] = 1.0
    return AliasTable(
        prob=torch.as_tensor(np.asarray(prob, np.float32), device=device),
        alias=torch.as_tensor(np.asarray(alias, np.int64), device=device))


def sample_alias(table: AliasTable, key: prng.KeyLike, shape) -> torch.Tensor:
    """Draw ids ~ unigram^power (int64). With a sequence of keys the result
    has a leading axis, one draw of ``shape`` per key."""
    dev = table.prob.device
    n = table.prob.shape[0]
    single = isinstance(key[0], int)
    pairs = [prng.split(k) for k in ([key] if single else key)]
    slot = prng.randint([p[0] for p in pairs], shape, 0, n, dev).to(torch.int64)
    u = prng.uniform([p[1] for p in pairs], shape, dev)
    out = torch.where(u < table.prob[slot], slot, table.alias[slot])
    return out[0] if single else out


# ---------------------------------------------------------------------------
# One lifetime batch: gather -> fused update -> write back
# ---------------------------------------------------------------------------


def _scatter_average(base: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor,
                     mask: torch.Tensor) -> None:
    """base[ids] += deltas, duplicates AVERAGED, in place.

    Hub nodes appear in many walks of one batch (power law!): each
    occurrence contributes delta / count(row), so a hot row's step stays
    bounded instead of multiplying by its duplicate count."""
    ones = mask.to(torch.float32)
    cnt = torch.zeros(base.shape[0], dtype=torch.float32,
                      device=base.device).index_add_(0, ids, ones)
    inv = torch.where(mask, 1.0 / cnt[ids].clamp_min(1.0), 0.0)
    base.index_add_(0, ids, deltas * inv[:, None])


def _write_back(phi_in, phi_out, safe_walks, negs, valid,
                ctx_buf, ctx0, out_buf, out0, neg_buf, neg0) -> None:
    """Scatter the buffer deltas of one replica back into its matrices."""
    dim = phi_in.shape[1]
    flat_ids = safe_walks.reshape(-1)
    mask = valid.reshape(-1)
    neg_ids = negs.reshape(-1)
    _scatter_average(phi_in, flat_ids, (ctx_buf - ctx0).reshape(-1, dim), mask)
    # phi_out receives deltas from both walk-token rows and negative rows;
    # average across the union so a hot node's total step stays bounded.
    _scatter_average(
        phi_out, torch.cat([flat_ids, neg_ids]),
        torch.cat([(out_buf - out0).reshape(-1, dim),
                   (neg_buf - neg0).reshape(-1, dim)]),
        torch.cat([mask, torch.ones_like(neg_ids, dtype=torch.bool)]))


def _replica_step(phi_in, phi_out, walks, negs, lr: float, window: int) -> torch.Tensor:
    """One lifetime batch over stacked replicas, in place: phi (S, N, d),
    walks (S, G, W, T), negs (S, G, T, K). The replica axis is merged into
    the lifetime axis for the fused update (one launch for all replicas).
    Returns the loss per replica (S,)."""
    s_cnt, g_cnt, w_cnt, t_len = walks.shape
    safe = walks.clamp_min(0).to(torch.int64)
    valid = walks >= 0
    rep = torch.arange(s_cnt, device=walks.device)
    ctx0 = phi_in[rep[:, None, None, None], safe]          # (S, G, W, T, d)
    out0 = phi_out[rep[:, None, None, None], safe]
    neg0 = phi_out[rep[:, None, None, None], negs]         # (S, G, T, K, d)
    merge = lambda a: a.reshape(s_cnt * g_cnt, *a.shape[2:])
    ctx_buf, out_buf, neg_buf, loss = sgns_ops.sgns_lifetime_batch(
        merge(ctx0), merge(out0), merge(neg0), merge(valid), lr, window)
    unmerge = lambda a: a.reshape(s_cnt, g_cnt, *a.shape[1:])
    ctx_buf, out_buf, neg_buf = unmerge(ctx_buf), unmerge(out_buf), unmerge(neg_buf)
    for s in range(s_cnt):
        _write_back(phi_in[s], phi_out[s], safe[s], negs[s], valid[s],
                    ctx_buf[s], ctx0[s], out_buf[s], out0[s], neg_buf[s], neg0[s])
    return loss.reshape(s_cnt, g_cnt).sum(dim=1)


def lifetime_step(phi_in, phi_out, walks, negs, lr: float, window: int) -> torch.Tensor:
    """Process G lifetimes of one (N, d) pair in place: gather buffers ->
    fused update -> write back deltas. Returns the summed loss."""
    return _replica_step(phi_in[None], phi_out[None], walks[None], negs[None],
                         lr, window)[0]


# ---------------------------------------------------------------------------
# A chunk of C lifetime batches
# ---------------------------------------------------------------------------


def train_chunk(
    phi_in: torch.Tensor,     # (S, N, d), updated in place
    phi_out: torch.Tensor,    # (S, N, d), updated in place
    walks: torch.Tensor,      # (C, S, G, W, T) int32 — C lifetime batches
    neg_table: AliasTable,
    key: prng.Key,            # key of the chunk's negative draws
    lrs: Sequence[float],     # (C,) per-step learning rates
    window: int,
    negatives: int,
) -> torch.Tensor:
    """Train C lifetime batches in order. Step c draws its negatives from
    the c-th key of the chain ``key, sub = split(key)``, as the reference's
    scan does; all C draws run as one batch. Returns the losses (C, S)."""
    s_cnt = phi_in.shape[0]
    c_cnt, _, g_cnt, _, t_len = walks.shape
    subs = []
    for _ in range(c_cnt):
        key, sub = prng.split(key)
        subs.append(sub)
    negs = sample_alias(neg_table, subs, (s_cnt, g_cnt, t_len, negatives))
    return torch.stack([
        _replica_step(phi_in, phi_out, walks[c], negs[c], float(lrs[c]), window)
        for c in range(c_cnt)])


def train_chunk_checked(phi_in, phi_out, walks, neg_table, key, lrs,
                        window: int, negatives: int):
    """``train_chunk`` on copies of the matrices, plus the watchdog's health
    reductions: non-finite counts over the new matrices and the losses, the
    loss sum, the Frobenius norm of the update and the new phi_in norm.
    Returns (phi_in', phi_out', losses, health)."""
    new_in, new_out = phi_in.clone(), phi_out.clone()
    losses = train_chunk(new_in, new_out, walks, neg_table, key, lrs,
                         window, negatives)
    finite = torch.isfinite(losses)
    health = {
        "nonfinite": (~torch.isfinite(new_in)).sum() + (~torch.isfinite(new_out)).sum(),
        "loss_nonfinite": (~finite).sum(),
        "loss_sum": torch.where(finite, losses, 0.0).sum(),
        "update_norm": torch.sqrt(((new_in - phi_in) ** 2).sum()
                                  + ((new_out - phi_out) ** 2).sum()),
        "phi_norm": torch.sqrt((new_in ** 2).sum()),
    }
    return new_in, new_out, losses, health
