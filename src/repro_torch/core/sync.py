"""Hotness-block synchronization (paper §4.2 Improvement-III).

Nodes with the same corpus occurrence count form contiguous ranges of the
frequency order: the hotness blocks B(i). One synchronization samples ONE
row per block and averages exactly those rows across the shard replicas:

* a node of B(i) is sampled with probability 1/|B(i)|: hot nodes (small
  blocks, often single nodes) sync nearly every period, the long cold tail
  rarely, matching sync frequency to update frequency;
* a period moves O(ocn_max · d · m) bytes instead of O(|V| · d · m)
  (ocn_max bounds the number of blocks).

``full_sync`` is the baseline the paper compares against. The replica-list
forms return the bytes they moved; ``hotness_sync_stacked`` is the same
exchange over the (S, N, d) replica stacks, in place, which the DSGL chunk
runs after its steps (``core.dsgl``). ``replica_mean`` rounds as the
reference's ``jnp.mean`` over the replica axis does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

Replica = Tuple[torch.Tensor, torch.Tensor]  # (phi_in, phi_out)


def sample_hotness_rows(starts: np.ndarray, ends: np.ndarray,
                        rng: np.random.Generator) -> np.ndarray:
    """One uniformly sampled rank per hotness block."""
    if len(starts) == 0:
        return np.zeros(0, dtype=np.int64)
    u = rng.random(len(starts))
    return starts + np.floor(u * (ends - starts)).astype(np.int64)


def replica_mean(stack: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean over the leading (replica) axis: the replicas summed in
    order, then times the float32 reciprocal of their number, as XLA
    computes ``jnp.mean``."""
    acc = stack[0]
    for x in stack[1:]:
        acc = acc + x
    return acc * float(np.float32(1) / np.float32(len(stack)))


def hotness_sync_stacked(phi_in: torch.Tensor, phi_out: torch.Tensor,
                         rows: torch.Tensor) -> None:
    """Average the ``rows`` (distinct ids, or repeats of one id: each copy
    writes the same mean) across the replica axis of the contiguous
    (S, N, d) stacks and write the mean into every replica, in place: one
    gather and one copy over the stacked rows."""
    s_cnt, n, d = phi_in.shape
    flat = (rows.view(1, -1) + n * torch.arange(s_cnt, device=rows.device).view(-1, 1)).view(-1)
    for phi in (phi_in, phi_out):
        table = phi.view(s_cnt * n, d)
        mean = replica_mean(table.index_select(0, flat).view(s_cnt, -1, d))      # (R, d)
        table.index_copy_(0, flat, mean.repeat(s_cnt, 1))


def hotness_block_sync(replicas: List[Replica], starts: np.ndarray, ends: np.ndarray,
                       rng: np.random.Generator) -> Tuple[List[Replica], float]:
    """Average the sampled hotness rows across replicas. Returns the new
    replica list and the bytes moved (rows * d * 4 B * m replicas * 2
    matrices)."""
    m = len(replicas)
    if m <= 1:
        return replicas, 0.0
    rows = sample_hotness_rows(starts, ends, rng)
    if rows.size == 0:
        return replicas, 0.0
    idx = torch.as_tensor(rows, device=replicas[0][0].device)
    mean_in = replica_mean([r[0][idx] for r in replicas])
    mean_out = replica_mean([r[1][idx] for r in replicas])
    out = []
    for phi_in, phi_out in replicas:
        phi_in, phi_out = phi_in.clone(), phi_out.clone()
        phi_in[idx], phi_out[idx] = mean_in, mean_out
        out.append((phi_in, phi_out))
    dim = int(replicas[0][0].shape[1])
    return out, float(rows.size * dim * 4 * m * 2)


def full_sync(replicas: List[Replica]) -> Tuple[List[Replica], float]:
    """Baseline: average EVERY row across replicas, O(|V| d m) bytes."""
    m = len(replicas)
    if m <= 1:
        return replicas, 0.0
    mean_in = replica_mean([r[0] for r in replicas])
    mean_out = replica_mean([r[1] for r in replicas])
    n, d = replicas[0][0].shape
    return [(mean_in, mean_out) for _ in range(m)], float(n * d * 4 * m * 2)


def sync_cost_model(num_nodes: int, dim: int, m: int,
                    num_blocks: int) -> Tuple[float, float]:
    """(hotness_bytes, full_bytes) per synchronization period: the paper's
    O(ocn_max d m) against O(|V| d m), in bytes."""
    return (float(num_blocks * dim * 4 * m * 2), float(num_nodes * dim * 4 * m * 2))
