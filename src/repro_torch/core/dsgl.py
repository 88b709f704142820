"""DSGL — distributed Skip-Gram learning (paper §4).

Improvement-I (global matrices + local buffers): each training lifetime
gathers the rows it will touch into local buffers, performs every update
there (``kernels.sgns``: the CUDA kernel on the card, the plain version on
the CPU) and writes the deltas back once at the end.

Improvement-II (multi-window shared negatives): ``multi_windows`` walks
train together per lifetime; their context windows share one negative set
per position, and each walk's target is an extra negative for the others.

Improvement-III (hotness-block sync): with S > 1 replicas a chunk may end
with the exchange of sampled hotness rows across the replica axis
(``core.sync.hotness_sync_stacked``).

The embedding matrices are (S, N, d) stacks of S replicas and are updated
in place. Negatives are drawn on the device from a Vose alias table, for a
whole chunk of lifetimes at once. Duplicate buffer rows of one batch are
AVERAGED on write-back (``kernels.sgns.ref.write_back_ref``); on the card
the write-back adds each row's deltas in the reference's slot order, so a
chunk from the same state gives the same phi on every run. On the card a
chunk runs as one CUDA graph replay (``ChunkGraphs``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.sync import hotness_sync_stacked
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
    slot, u = prng.randint_and_uniform([p[0] for p in pairs], [p[1] for p in pairs], shape,
                                       0, n, dev)
    slot = slot.to(torch.int64)
    out = torch.where(u < table.prob[slot], slot, table.alias[slot])
    return out[0] if single else out


# ---------------------------------------------------------------------------
# One lifetime batch: gather -> fused update -> write back
# ---------------------------------------------------------------------------


def _replica_step(phi_in, phi_out, walks, negs, lr, window: int) -> torch.Tensor:
    """One lifetime batch over stacked replicas, in place: phi (S, N, d),
    walks (S, G, W, T), negs (S, G, T, K), lr a float or a one-element
    tensor. The step (``sgns_ops.sgns_step``) runs every (replica, lifetime)
    pair in one launch and writes the live rows back. Returns the loss per
    replica (S,)."""
    dev = phi_in.device
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev).reshape(1)
    return sgns_ops.sgns_step(phi_in, phi_out, walks.to(torch.int32).contiguous(),
                              negs.to(torch.int32).contiguous(), lr, window)


def lifetime_step(phi_in, phi_out, walks, negs, lr: float, window: int) -> torch.Tensor:
    """Process G lifetimes of one (N, d) pair in place: gather buffers ->
    fused update -> write back deltas. Returns the summed loss."""
    return _replica_step(phi_in[None], phi_out[None], walks[None], negs[None],
                         lr, window)[0]


# ---------------------------------------------------------------------------
# A chunk of C lifetime batches
# ---------------------------------------------------------------------------


def chunk_negatives(neg_table: AliasTable, key: prng.Key, walks_shape,
                    negatives: int) -> torch.Tensor:
    """The negatives of a (C, S, G, W, T) chunk, (C, S, G, T, K) int32: step
    c draws from the c-th key of the chain ``key, sub = split(key)``, as the
    reference's scan does; all C draws run as one batch."""
    c_cnt, s_cnt, g_cnt, _, t_len = walks_shape
    subs = []
    for _ in range(c_cnt):
        key, sub = prng.split(key)
        subs.append(sub)
    return sample_alias(neg_table, subs, (s_cnt, g_cnt, t_len, negatives)).to(torch.int32)


def train_chunk(
    phi_in: torch.Tensor,     # (S, N, d), updated in place
    phi_out: torch.Tensor,    # (S, N, d), updated in place
    walks: torch.Tensor,      # (C, S, G, W, T) int32 — C lifetime batches
    neg_table: AliasTable,
    key: prng.Key,            # key of the chunk's negative draws
    lrs: Sequence[float],     # (C,) per-step learning rates
    window: int,
    negatives: int,
    sync_rows: torch.Tensor = None,  # (R,) int64 hotness rows, node ids
    sync: bool = False,
) -> torch.Tensor:
    """Train C lifetime batches in order, step by step; with ``sync`` (and
    S > 1 replicas) the chunk ends with the hotness-row exchange of
    ``sync_rows``. Returns the losses (C, S)."""
    negs = chunk_negatives(neg_table, key, walks.shape, negatives)
    lrs = torch.as_tensor(np.asarray(lrs, np.float32), device=phi_in.device)
    losses = torch.stack([
        _replica_step(phi_in, phi_out, walks[c], negs[c], lrs[c:c + 1], window)
        for c in range(walks.shape[0])])
    if sync and phi_in.shape[0] > 1:
        hotness_sync_stacked(phi_in, phi_out, sync_rows.to(phi_in.device))
    return losses


GRAPH_REPLAYS = 0    # chunks run as one CUDA graph replay (``ChunkGraphs``)


class ChunkGraphs:
    """``train_chunk`` on the card as one CUDA graph replay per chunk, as the
    reference runs a chunk as one XLA dispatch.

    A chunk of C steps is captured once (C lifetime-kernel and write-back
    launches reading static walks, negatives and learning-rate buffers)
    per chunk length and per storage of phi_in / phi_out; each call draws
    the chunk's negatives, fills the static buffers and replays. A graph
    holds phi's pointers: whoever rebinds phi makes a new ``ChunkGraphs``.
    A capture or replay failure raises; nothing runs eagerly instead.
    Each replay adds C to ``sgns_ops.LAUNCHES`` and ``sgns_ops.WRITEBACKS``
    and one to ``GRAPH_REPLAYS``.

    A chunk that ends with a hotness sync replays a graph of its own that
    ends with the sync, from a static rows buffer of a power-of-two size
    whose tail repeats the last row (a repeated row writes the same mean
    again). It measured cheaper than the sync run after the replay
    (``kernels/sgns/bench.py``)."""

    def __init__(self):
        self._graphs = {}

    def train_chunk(self, phi_in, phi_out, walks, neg_table, key, lrs, window: int,
                    negatives: int, sync_rows: torch.Tensor = None,
                    sync: bool = False) -> torch.Tensor:
        """Same arguments and result as ``train_chunk``."""
        rows = sync_rows if sync and phi_in.shape[0] > 1 and len(sync_rows) else None
        cap = 0 if rows is None else 1 << (len(rows) - 1).bit_length()
        sig = (tuple(walks.shape), negatives, window, tuple(phi_in.shape),
               phi_in.data_ptr(), phi_out.data_ptr(), cap)
        graph = self._graphs.get(sig)
        if graph is None:
            graph = self._graphs[sig] = _ChunkGraph(phi_in, phi_out, walks.shape,
                                                    negatives, window, cap)
        return graph.replay(walks, chunk_negatives(neg_table, key, walks.shape, negatives),
                            lrs, rows)


class _ChunkGraph:
    """One captured chunk: its static inputs, scratch and graph, all held
    for the graph's life (a replay writes into the addresses captured);
    with ``sync_cap`` > 0 it ends with the sync of a static buffer of that
    many rows."""

    def __init__(self, phi_in, phi_out, walks_shape, negatives: int, window: int,
                 sync_cap: int = 0):
        if phi_in.device.type != "cuda":
            raise ValueError(f"ChunkGraphs: phi must be on a CUDA device, not {phi_in.device}")
        c_cnt, s_cnt, g_cnt, w_cnt, t_len = walks_shape
        dev = phi_in.device
        self.steps, self.lifetimes = c_cnt, (s_cnt, g_cnt)
        self.walks = torch.empty(tuple(walks_shape), dtype=torch.int32, device=dev)
        self.negs = torch.empty((c_cnt, s_cnt, g_cnt, t_len, negatives), dtype=torch.int32,
                                device=dev)
        self.lrs = torch.empty(c_cnt, dtype=torch.float32, device=dev)
        self.loss = torch.empty(c_cnt, s_cnt * g_cnt, dtype=torch.float32, device=dev)
        self.rows = torch.empty(sync_cap, dtype=torch.int64, device=dev)
        # Every replay writes its deltas here and the write-back reads them:
        # the scratch lives as long as the graph, as the static inputs do.
        self.scratch = sgns_ops.StepScratch.empty((s_cnt, g_cnt, w_cnt, t_len), negatives,
                                                  phi_in.shape[-1], dev)
        sgns_ops.LIBRARY.load()                # the library's init, outside the capture
        self.graph = torch.cuda.CUDAGraph()
        counts = sgns_ops.LAUNCHES, sgns_ops.WRITEBACKS
        with torch.cuda.graph(self.graph):
            for c in range(c_cnt):
                sgns_ops.launch_step(phi_in, phi_out, self.walks[c], self.negs[c],
                                     self.lrs[c:c + 1], window,
                                     dataclasses.replace(self.scratch, loss=self.loss[c]))
            if sync_cap:
                hotness_sync_stacked(phi_in, phi_out, self.rows)
        sgns_ops.LAUNCHES, sgns_ops.WRITEBACKS = counts     # a capture launches nothing

    def replay(self, walks, negs, lrs, rows=None) -> torch.Tensor:
        global GRAPH_REPLAYS
        self.walks.copy_(walks)
        self.negs.copy_(negs)
        self.lrs.copy_(torch.from_numpy(np.asarray(lrs, np.float32)).pin_memory(),
                       non_blocking=True)
        if len(self.rows):
            rows = rows.to(self.rows.device, non_blocking=True)
            self.rows[:len(rows)].copy_(rows)
            self.rows[len(rows):].copy_(rows[-1:].expand(len(self.rows) - len(rows)))
        self.graph.replay()
        sgns_ops.LAUNCHES += self.steps
        sgns_ops.WRITEBACKS += self.steps
        GRAPH_REPLAYS += 1
        return self.loss.view(self.steps, *self.lifetimes).sum(dim=-1)


def chunk_health(phi_in, phi_out, pre_in, pre_out, losses) -> Dict[str, torch.Tensor]:
    """The watchdog's five reductions of a trained chunk, as device scalars
    (the reference's, ``core/dsgl.py:354-362``): non-finite counts over the
    new matrices and the chunk's losses, the finite losses' sum, the
    Frobenius norm of the update against the pre-chunk matrices and the new
    phi_in norm. Each norm reads its operands once, with no squared copy."""
    finite = torch.isfinite(losses)
    norm = torch.linalg.vector_norm
    return {
        "nonfinite": (phi_in.numel() - torch.isfinite(phi_in).sum())
                     + (phi_out.numel() - torch.isfinite(phi_out).sum()),
        "loss_nonfinite": (~finite).sum(),
        "loss_sum": torch.where(finite, losses, 0.0).sum(),
        "update_norm": torch.hypot(norm(phi_in - pre_in), norm(phi_out - pre_out)),
        "phi_norm": norm(phi_in),
    }


def train_chunk_checked_in_place(train, pre, phi_in, phi_out, walks, neg_table, key, lrs,
                                 window: int, negatives: int,
                                 sync_rows: torch.Tensor = None, sync: bool = False):
    """A chunk the watchdog checks, trained in place: phi is copied into
    ``pre``, a persistent (phi_in, phi_out) buffer pair, ``train`` trains
    phi in place and ``chunk_health`` reduces it against the copy.
    ``train`` is ``train_chunk`` or, on the card, ``ChunkGraphs.train_chunk``:
    the graph an unchecked chunk replays, so phi is bit-equal to an
    unchecked run's and no graph is captured for checking. Returns
    (losses, health), health as device scalars."""
    pre_in, pre_out = pre
    pre_in.copy_(phi_in)
    pre_out.copy_(phi_out)
    losses = train(phi_in, phi_out, walks, neg_table, key, lrs, window, negatives,
                   sync_rows=sync_rows, sync=sync)
    return losses, chunk_health(phi_in, phi_out, pre_in, pre_out, losses)


def train_chunk_checked(phi_in, phi_out, walks, neg_table, key, lrs,
                        window: int, negatives: int, sync_rows: torch.Tensor = None,
                        sync: bool = False):
    """The reference's form of ``train_chunk_checked_in_place``: the chunk
    trains copies of the matrices, which it returns with the losses and the
    health reductions, (phi_in', phi_out', losses, health)."""
    new_in, new_out = phi_in.clone(), phi_out.clone()
    losses, health = train_chunk_checked_in_place(
        train_chunk, (torch.empty_like(phi_in), torch.empty_like(phi_out)), new_in, new_out,
        walks, neg_table, key, lrs, window, negatives, sync_rows, sync)
    return new_in, new_out, losses, health


# ---------------------------------------------------------------------------
# The two-phase path
# ---------------------------------------------------------------------------


def _group_walks(walks: np.ndarray, w_cnt: int, g_cnt: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Shuffle walks and pack them into (num_steps, G, W, T) batches (the
    tail dropped; a corpus smaller than one batch is repeated)."""
    order = rng.permutation(walks.shape[0])
    per_step = g_cnt * w_cnt
    n_steps = len(order) // per_step
    if n_steps == 0:
        reps = -(-per_step // max(len(order), 1))
        order = np.tile(order, reps)[:per_step]
        n_steps = 1
    order = order[: n_steps * per_step]
    return walks[order].reshape(n_steps, g_cnt, w_cnt, walks.shape[1])


def train_dsgl(corpus, order, cfg: DSGLConfig, *, num_shards: int = 1,
               collect_metrics: bool = False, device="cuda"):
    """Train Skip-Gram embeddings over a materialized corpus, in rank space.

    ``num_shards`` > 1 runs the paper's distributed regime: shard s trains
    replica s on every num_shards-th walk, and every chunk of
    ``cfg.sync_period`` lifetimes ends with a hotness-block sync
    (Improvement-III). The walks are shuffled and the hotness rows drawn
    from one generator, the chunk keys chained, as the reference does.
    Returns (phi_in, phi_out) in RANK space (row 0 = hottest node; map ids
    with ``order.to_rank``), replica-averaged, on ``device``, plus the
    metrics (losses, sync bytes, steps) with ``collect_metrics``."""
    from repro_torch.core.sync import replica_mean, sample_hotness_rows
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    n = len(order.to_rank)
    walks_rank = order.relabel_walks(corpus.walks)
    neg_table = build_alias_table(order.sorted_ocn, cfg.neg_power, dev)
    rng = np.random.default_rng(cfg.seed)
    key, *rep_keys = prng.split(prng.PRNGKey(cfg.seed), num_shards + 1)
    replicas = [init_embeddings(n, cfg.dim, k, dev) for k in rep_keys]
    phi_in = torch.stack([r[0] for r in replicas])       # (S, N, d)
    phi_out = torch.stack([r[1] for r in replicas])

    shard_walks = [walks_rank[s::num_shards] for s in range(num_shards)]
    starts, ends = order.hotness_blocks()
    metrics = {"loss": [], "sync_bytes": 0.0, "steps": 0}
    do_sync = num_shards > 1
    chunk = max(cfg.sync_period, 1)
    train = ChunkGraphs().train_chunk if dev.type == "cuda" else train_chunk

    for epoch in range(cfg.epochs):
        batches = [_group_walks(sw, cfg.multi_windows, cfg.batch_groups, rng)
                   for sw in shard_walks]
        n_steps = min(b.shape[0] for b in batches)
        stacked = np.stack([b[:n_steps] for b in batches], axis=1)
        total = max(cfg.epochs * n_steps, 1)
        for c0 in range(0, n_steps, chunk):
            c1 = min(c0 + chunk, n_steps)
            fracs = (epoch * n_steps + np.arange(c0, c1)) / total
            lrs = np.maximum(cfg.lr * (1.0 - fracs), cfg.min_lr).astype(np.float32)
            wb = torch.from_numpy(stacked[c0:c1]).to(dev)      # one upload per chunk
            rows = (torch.from_numpy(sample_hotness_rows(starts, ends, rng))
                    if do_sync else None)
            key, sub = prng.split(key)
            losses = train(phi_in, phi_out, wb, neg_table, sub, lrs, cfg.window,
                           cfg.negatives, sync_rows=rows, sync=do_sync)
            metrics["steps"] += c1 - c0
            if do_sync:
                metrics["sync_bytes"] += float(rows.numel() * cfg.dim * 4 * num_shards * 2)
            if collect_metrics:
                metrics["loss"].extend(float(v) for v in losses.reshape(-1).tolist())

    if num_shards > 1:
        phi_in, phi_out = replica_mean(phi_in), replica_mean(phi_out)
    else:
        phi_in, phi_out = phi_in[0], phi_out[0]
    if collect_metrics:
        return phi_in, phi_out, metrics
    return phi_in, phi_out
