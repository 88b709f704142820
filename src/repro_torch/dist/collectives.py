"""The walk engine's cross-shard exchanges, in stacked form.

The reference writes them for a named mesh axis, inside ``shard_map`` or
``vmap``. Here the k shards are the leading axis of every per-shard
tensor, on one device, and each collective is a function over that axis:

* ``lax.psum`` is a sum over dim 0 (every shard sees the one result);
* ``lax.all_gather`` is the stacked tensor itself, seen by every shard;
* ``lax.all_to_all`` is a transpose of the (source, destination) axes;
* ``lax.axis_index`` is ``arange(k)``.

The functions keep the reference's names and results, so that a form over
``torch.distributed`` (one process a shard) swaps only their bodies.
Payloads are dicts of tensors whose leading axes are (k, P).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Payload = Dict[str, torch.Tensor]


def axis_index(num_shards: int, device) -> torch.Tensor:
    """Each shard's index, shaped to broadcast against (k, P) tensors."""
    return torch.arange(num_shards, device=device)[:, None]


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the shards, as every shard sees it (dim 0 reduced)."""
    return x.sum(0)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every shard's block, as every shard sees it: the stack itself."""
    return x


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """(source, destination, ...) buckets to (destination, source, ...):
    row d of the result is what every source addressed to shard d."""
    return x.transpose(0, 1)


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def psum_union(payload: Payload, mask: torch.Tensor) -> Payload:
    """Exactly-one-sender union: each shard contributes its (k, B, ...)
    leaves where ``mask`` (k, B) is set and zeros elsewhere, and the sum
    over the shards rebuilds each lane's payload exactly (negative values
    included) because at most one shard sends a lane. Returns (B, ...)."""
    return {name: psum(torch.where(_bcast(mask, x), x, torch.zeros((), dtype=x.dtype,
                                                                  device=x.device)))
            for name, x in payload.items()}


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 prefix sums of each shard's row of ``x`` (k, n): one
    scan of the flattened tensor, each row's offset taken off again. (A
    scan along the last axis of a few long rows runs a row to a block on
    the card, about a hundred times slower at a million lanes.)"""
    k, n = x.shape
    flat = torch.cumsum(x.reshape(-1).to(torch.int64), 0).reshape(k, n)
    if k == 1 or n == 0:
        return flat
    before = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return flat - before[:, None]


def rank_search(csum: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """For each query q, the first index i with csum[i] >= q (a lower
    bound); ``csum`` is non-decreasing along its last axis, and leading
    axes of ``csum`` and ``queries`` match."""
    return torch.searchsorted(csum, queries)


def take_ranked(payload: Payload, mask: torch.Tensor, count: int) -> Tuple[Payload, torch.Tensor]:
    """Compact each shard's first ``count`` mask-set lanes, in lane order:
    slot j of the result holds the j-th set lane. ``mask`` is (k, P); the
    leaves come back (k, count, ...) with the (k, count) validity mask."""
    k, p = mask.shape
    csum = row_cumsum(mask)
    j = torch.arange(count, device=mask.device).expand(k, count)
    src = rank_search(csum, (j + 1).contiguous()).clamp(0, max(p - 1, 0))
    valid = j < (csum[:, -1:] if p else torch.zeros_like(j[:, :1]))
    packed = {name: _take_rows(x, src) for name, x in payload.items()}
    return packed, valid


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[s, idx[s, j]]`` for every shard s (x is (k, P, ...))."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def packed_all_gather(payload: Payload, pending: torch.Tensor, cap: int
                      ) -> Tuple[Payload, torch.Tensor, torch.Tensor]:
    """Compacted sparse exchange, broadcast transport: each shard packs up
    to ``cap`` of its pending lanes (k, P) into a (cap, ...) record block,
    and one all-gather publishes every block. Receivers filter the records
    by destination themselves; lanes past ``cap`` stay pending for the
    caller's next round.

    Returns ``(records, valid, sent)``: leaves (k, cap, ...) with row s
    shard s's records, ``valid`` (k, cap) and ``sent`` (k, P), the lanes
    each shard shipped this round."""
    rank = row_cumsum(pending) - 1
    sent = pending & (rank < cap)
    packed, valid = take_ranked(payload, pending, cap)
    return {n: all_gather(x) for n, x in packed.items()}, all_gather(valid), sent


def packed_all_to_all(payload: Payload, dest: torch.Tensor, pending: torch.Tensor,
                      num_shards: int, cap: int
                      ) -> Tuple[Payload, torch.Tensor, torch.Tensor]:
    """Compacted sparse exchange, point to point: each shard ranks its
    pending lanes per destination, packs the first ``cap`` of each bucket
    into a (k_dst, cap, ...) send block, and one all-to-all swaps the
    buckets. Lanes past ``cap`` stay pending for the next round.

    Returns ``(arrivals, arr_valid, sent)``: leaves (k_dst, k_src, cap, ...)
    with [d, s] the records shard s addressed to d (zeros where invalid),
    ``arr_valid`` (k_dst, k_src, cap) and ``sent`` (k, P)."""
    k, p = pending.shape
    rank_of = torch.zeros_like(dest, dtype=torch.int64)
    for d in range(num_shards):          # one bucket at a time: no (k, k, P) one-hot
        hit = pending & (dest == d)
        rank_of = torch.where(hit, row_cumsum(hit) - 1, rank_of)
    sent = pending & (rank_of < cap)
    slot = torch.where(sent, dest.to(torch.int64) * cap + rank_of, num_shards * cap)
    flat = slot + torch.arange(k, device=slot.device)[:, None] * (num_shards * cap + 1)

    def pack(x: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros((k * (num_shards * cap + 1),) + x.shape[2:], dtype=x.dtype,
                          device=x.device)
        buf[flat.reshape(-1)] = x.reshape((k * p,) + x.shape[2:])
        buf = buf.reshape((k, num_shards * cap + 1) + x.shape[2:])[:, :num_shards * cap]
        return buf.reshape((k, num_shards, cap) + x.shape[2:])

    arrivals = {n: all_to_all(pack(x)) for n, x in payload.items()}
    return arrivals, all_to_all(pack(sent)), sent
