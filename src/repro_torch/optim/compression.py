"""Gradient-compression policies, pluggable into a trainer.

The port of the JAX package's ``optim/compression.py``:

* ``HotnessSync``: the paper's §4.2-III mechanism generalised to LM
  embedding tables. Rows are ranked by frequency; each sync period
  exchanges one row per hotness block instead of the whole table. Host
  numpy, as in the reference, so its blocks and sampled rows are bit for
  bit the reference's.
* ``TopKErrorFeedback``: sparsified all-reduce with memory (Stich et al.)
  on a tree of gradient tensors. The k largest magnitudes of each
  corrected gradient are picked by a stable descending sort, so ties go
  to the lowest index, as ``jax.lax.top_k`` breaks them (``torch.topk``
  does not promise an order among ties).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.optimizers import leaves, tree_map


@dataclasses.dataclass
class HotnessSync:
    """State for hotness-block embedding sync.

    ``block_starts``/``block_ends`` delimit equal-frequency rank ranges of
    the frequency-sorted table."""

    block_starts: np.ndarray
    block_ends: np.ndarray
    period: int = 50
    _step: int = 0

    @classmethod
    def from_counts(cls, counts: np.ndarray, period: int = 50) -> "HotnessSync":
        """counts[rank] = occurrences, already sorted descending."""
        counts = np.asarray(counts)
        edges = np.flatnonzero(np.diff(counts)) + 1
        starts = np.concatenate([[0], edges])
        ends = np.concatenate([edges, [len(counts)]])
        return cls(block_starts=starts, block_ends=ends, period=period)

    def due(self) -> bool:
        self._step += 1
        return self._step % self.period == 0

    def sample_rows(self, rng: np.random.Generator) -> np.ndarray:
        u = rng.random(len(self.block_starts))
        span = self.block_ends - self.block_starts
        return (self.block_starts + np.floor(u * span)).astype(np.int64)

    def bytes_per_period(self, dim: int, replicas: int) -> float:
        return float(len(self.block_starts) * dim * 4 * replicas)

    def full_bytes(self, num_rows: int, dim: int, replicas: int) -> float:
        return float(num_rows * dim * 4 * replicas)


def _top_k(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest |flat|, ties to the lowest index."""
    return torch.sort(torch.abs(flat), descending=True, stable=True).indices[:k]


@dataclasses.dataclass(frozen=True)
class _Pair:
    sparse: torch.Tensor
    residual: torch.Tensor


@dataclasses.dataclass
class TopKErrorFeedback:
    """Error-feedback top-k sparsification state (one tree of residuals)."""

    k_frac: float = 0.01
    residual: Optional[Any] = None

    def init(self, grads: Any) -> None:
        self.residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def compress(self, grads: Any) -> Tuple[Any, Any]:
        """Returns (sparse_grads_to_allreduce, new_residual_tree)."""
        if self.residual is None:
            self.init(grads)

        def one(g, r):
            flat = (g.float() + r).reshape(-1)
            k = max(1, int(flat.shape[0] * self.k_frac))
            idx = _top_k(flat, k)
            sparse = torch.zeros_like(flat).index_copy_(0, idx, flat[idx])
            return _Pair(sparse.reshape(g.shape).to(g.dtype), (flat - sparse).reshape(g.shape))

        pairs = tree_map(one, grads, self.residual)
        sparse = tree_map(lambda pair: pair.sparse, pairs)
        self.residual = tree_map(lambda pair: pair.residual, pairs)
        return sparse, self.residual

    def wire_bytes(self, grads: Any) -> float:
        """Index + value bytes per all-reduce."""
        total = sum(x.numel() for x in leaves(grads))
        k = int(total * self.k_frac)
        return float(k * 8)   # 4 B value + 4 B index
