"""Training batches: indices over the device corpus ring (the streaming
pipeline), lifetime batches of a materialized corpus with a prefetch
thread (the two-phase path), and the LM trainer's token stream with its
straggler policy.

``TokenStream.batch_at(step)`` is a pure function of (seed, step, shard),
bit for bit the reference's, so a restarted run re-reads the batches it
lost and a backup replica produces the primary's bytes;
``BackupShardFetcher`` races a primary fetch against such a backup once a
deadline passes.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng


def ring_chunk_indices(key: prng.Key, base: int, pool: int, count: int,
                       shards: int, groups: int, windows: int,
                       device) -> torch.Tensor:
    """Device-side (C, S, G, W) ring-slot index tensor.

    Samples ``count`` lifetimes per shard without replacement (tiling when
    the pool is smaller than one chunk) from ring slots
    [``base``, ``base + pool``); the result drives one device gather
    ``ring.walks[idx]`` that assembles the (C, S, G, W, T) training chunk.
    """
    need = count * shards * groups * windows
    perm = prng.permutation(key, pool, device)
    if need > pool:                         # np.resize: repeat cyclically
        perm = perm.repeat(-(-need // pool))
    return base + perm[:need].reshape(count, shards, groups, windows)


# ---------------------------------------------------------------------------
# Token stream (LM training)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Synthetic but deterministic LM token stream with next-token labels:
    a batch depends only on (seed, step, shard_id), never on wall-clock or
    fetch order. Host numpy, int32, as the reference's."""

    vocab_size: int
    batch_per_shard: int
    seq_len: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.shard_id)
        toks = rng.integers(0, self.vocab_size, size=(self.batch_per_shard, self.seq_len + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


# ---------------------------------------------------------------------------
# The two-phase path: batches from a materialized corpus
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WalkCorpusStream:
    """Batches of walk lifetimes from a materialized corpus (the two-phase
    learner's input). The shuffle order is a pure function of (seed,
    epoch); the cursor (epoch, step) names a batch."""

    walks: np.ndarray            # (n_walks, T) int32, -1 padded
    group_size: int              # G lifetimes per batch
    multi_windows: int           # W walks per lifetime
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 7919 + epoch)
        order = rng.permutation(self.walks.shape[0])
        return order[self.shard_id::self.num_shards]

    def steps_per_epoch(self) -> int:
        per = self.group_size * self.multi_windows
        return max(len(self._order(0)) // per, 1)

    def batch_at(self, epoch: int, step: int) -> np.ndarray:
        order = self._order(epoch)
        per = self.group_size * self.multi_windows
        if len(order) < per:   # tiny corpora: tile
            order = np.tile(order, -(-per // max(len(order), 1)))
        lo = (step * per) % max(len(order) - per + 1, 1)
        sel = order[lo:lo + per]
        return self.walks[sel].reshape(self.group_size, self.multi_windows,
                                       self.walks.shape[1])

    def chunk_at(self, epoch: int, step: int, chunk: int) -> np.ndarray:
        """``chunk`` consecutive batches stacked to (C, G, W, T), the unit one
        ``core.dsgl.train_chunk`` call trains."""
        return np.stack([self.batch_at(epoch, step + c) for c in range(chunk)])


def stacked_shard_chunk(streams: Sequence[WalkCorpusStream], epoch: int, step: int,
                        chunk: int) -> np.ndarray:
    """Chunks from every shard's stream stacked to (C, S, G, W, T): replica
    s trains on its own slice of the corpus."""
    return np.stack([s.chunk_at(epoch, step, chunk) for s in streams], axis=1)


class Prefetcher:
    """Bounded background prefetch over any ``fetch(step)`` source."""

    def __init__(self, fetch: Callable[[int], object], depth: int = 2,
                 start_step: int = 0):
        self._fetch = fetch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fetch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: float = 60.0):
        return self._q.get(timeout=timeout)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Straggler mitigation: backup-shard speculative fetch
# ---------------------------------------------------------------------------


class BackupShardFetcher:
    """Race a primary fetch against a backup after ``deadline_s``.

    Batches are pure functions of (step, shard), so the backup produces the
    primary's bytes and speculation never changes the training data.
    ``delay_injector(step) -> seconds`` simulates slow primaries in tests.
    """

    def __init__(self, primary: Callable[[int], object], backup: Callable[[int], object],
                 deadline_s: float = 0.5,
                 delay_injector: Optional[Callable[[int], float]] = None):
        self.primary = primary
        self.backup = backup
        self.deadline_s = deadline_s
        self.delay_injector = delay_injector
        self.stats = {"primary": 0, "backup": 0}

    def fetch(self, step: int):
        result = {}
        done = threading.Event()
        lock = threading.Lock()

        def offer(value, source: str) -> None:
            with lock:
                if not done.is_set():
                    result["value"], result["source"] = value, source
                    done.set()

        def run_primary():
            if self.delay_injector:
                time.sleep(self.delay_injector(step))
            offer(self.primary(step), "primary")

        threading.Thread(target=run_primary, daemon=True).start()
        if not done.wait(self.deadline_s):
            offer(self.backup(step), "backup")      # deadline passed: speculative fetch
        self.stats[result["source"]] += 1
        return result["value"]
