"""The walk engine's cross-shard exchanges, in two forms, and the SPMD
collectives of the embedding and LM layers.

The reference writes the exchanges for a named mesh axis, inside
``shard_map`` or ``vmap``. Here a per-shard tensor has a leading axis of
the shards this process holds, and each collective has two forms:

* **stacked** (``group=None``): all k shards are that axis, on one device
  (the reference's ``vmap`` emulation). ``lax.psum`` is a sum over dim 0,
  ``lax.all_gather`` the stacked tensor itself, ``lax.all_to_all`` a
  transpose of the (source, destination) axes, ``lax.axis_index``
  ``arange(k)``;
* **process group** (``group`` a ``torch.distributed`` group of k ranks,
  one shard a rank; the reference's ``shard_map`` on a mesh): the axis has
  length 1, the rank's own shard, and the same four are the rank,
  ``all_reduce``, ``all_gather_into_tensor`` and ``all_to_all_single``.

The functions keep the reference's names and results, and
``psum_union``, ``packed_all_gather`` and ``packed_all_to_all`` run the
same code in both forms. Payloads are dicts of tensors whose leading axes
are (shards held, P).

The transport is the group's backend. A gloo group takes host tensors, so
a CUDA tensor is staged through the host explicitly (``.cpu()``, the
collective, ``.to(device)``): that is how k ranks share one card, which
NCCL refuses. Under NCCL (one card a rank) nothing is staged. Booleans
travel as uint8. ``PG_STATS`` counts the collectives run over a group and
the bytes staged through the host, both ways.

``hotness_sync_spmd`` and ``compressed_allreduce`` are the reference's
SPMD forms of the hotness-block sync and of the top-|g| all-reduce with
error feedback, over a ``DeviceMesh`` axis; ``local_mesh`` is its
one-axis mesh over the first k ranks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

Payload = Dict[str, torch.Tensor]

#: Collectives run over a process group, and the bytes staged through the
#: host for them (to the host and back).
PG_STATS = {"collectives": 0, "staged_bytes": 0}


def reset_pg_stats() -> None:
    PG_STATS.update(collectives=0, staged_bytes=0)


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend takes it: bools as uint8, and a CUDA
    tensor on the host under gloo."""
    PG_STATS["collectives"] += 1
    w = x.to(torch.uint8) if x.dtype == torch.bool else x
    if w.is_cuda and dist.get_backend(group) == "gloo":
        PG_STATS["staged_bytes"] += w.numel() * w.element_size()
        w = w.cpu()
    return w.contiguous()


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if w.device != like.device:
        PG_STATS["staged_bytes"] += w.numel() * w.element_size()
        w = w.to(like.device)
    return w.bool() if like.dtype == torch.bool else w


def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)


def axis_index(num_shards: int, device, group=None) -> torch.Tensor:
    """Each held shard's index, shaped to broadcast against (k, P) tensors."""
    if group is None:
        return torch.arange(num_shards, device=device)[:, None]
    return torch.full((1, 1), dist.get_rank(group), dtype=torch.int64, device=device)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the shards, as every shard sees it (dim 0 reduced).
    Over a group: the ranks' rows all-gathered, then the stacked form's sum
    over dim 0, so the order of a float sum is the stacked one (and a small
    all-gather is cheaper than gloo's all-reduce)."""
    s = x.sum(0)
    if group is None:
        return s
    return all_gather(s[None], group).sum(0)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every shard's block, as every shard sees it: (k, ...). Stacked,
    the stack itself; over a group, the ranks' (1, ...) blocks in rank
    order."""
    if group is None:
        return x
    w = _wire(x, group)
    out = w.new_empty((dist.get_world_size(group) * w.shape[0],) + tuple(w.shape[1:]))
    _all_gather_into(out, w, group)
    return _unwire(out, x)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """(source, destination, ...) buckets to (destination, source, ...):
    row d of the result is what every source addressed to shard d (over a
    group, the rank's own row: (1, k_src, ...))."""
    if group is None:
        return x.transpose(0, 1)
    w = _wire(x[0], group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _unwire(out, x)[None]


def _fused(op, payload: Payload, lead: int) -> Payload:
    """``op`` once for a whole payload whose leaves share their first
    ``lead`` dims: each leaf is viewed as bytes along one trailing axis,
    the views are concatenated, ``op`` maps the (lead..., bytes) tensor to
    (lead'..., bytes), and the result is cut and viewed back. One
    collective a payload instead of one a leaf."""
    names, widths, views = list(payload), [], []
    for name in names:
        x = payload[name].contiguous()
        x = x.to(torch.uint8) if x.dtype == torch.bool else x
        b = x.reshape(tuple(x.shape[:lead]) + (-1,)).view(torch.uint8)
        widths.append(b.shape[-1])
        views.append(b)
    out = op(torch.cat(views, -1))
    parts = torch.split(out, widths, -1)
    res = {}
    for name, part in zip(names, parts):
        like = payload[name]
        dt = torch.uint8 if like.dtype == torch.bool else like.dtype
        y = part.contiguous().view(dt).reshape(tuple(out.shape[:lead]) + tuple(like.shape[lead:]))
        res[name] = y.bool() if like.dtype == torch.bool else y
    return res


def all_gather_tree(payload: Payload, group=None) -> Payload:
    """``all_gather`` of every leaf ((shards held, ...) each); over a group
    one collective for them all."""
    if group is None:
        return dict(payload)
    return _fused(lambda x: all_gather(x, group), payload, 1)


def _to_i64(x: torch.Tensor) -> torch.Tensor:
    """An exact int64 stand-in for a sum where at most one term is not zero:
    float32 as its bit pattern."""
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64)
    return x.to(torch.int64)


def _from_i64(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.float32:
        # + 0.0: a float sum of -0.0 and zeros is +0.0, as the stacked form's
        return y.to(torch.int32).view(torch.float32) + 0.0
    return y.to(like.dtype)


def host_read(values: List[torch.Tensor], group=None) -> List[int]:
    """Integer 0-d tensors read back to the host as one decision every
    shard shares: stacked, the values themselves; over a group, their
    maximum over the ranks. A loop that a read decides then runs the same
    trips on every rank."""
    v = torch.stack([t.to(torch.int64) for t in values])
    if group is not None:
        v = all_gather(v[None], group).max(0).values
    return v.tolist()


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def psum_union(payload: Payload, mask: torch.Tensor, group=None) -> Payload:
    """Exactly-one-sender union: each shard contributes its (k, B, ...)
    leaves where ``mask`` (k, B) is set and zeros elsewhere, and the sum
    over the shards rebuilds each lane's payload exactly (negative values
    included) because at most one shard sends a lane. Returns (B, ...).
    Over a group the leaves travel as one int64 all-reduce (float32 as its
    bits: a sum with only zeros beside it is exact either way)."""
    masked = {name: torch.where(_bcast(mask, x), x, torch.zeros((), dtype=x.dtype,
                                                               device=x.device))
              for name, x in payload.items()}
    if group is None:
        return {name: psum(x) for name, x in masked.items()}
    b = mask.shape[1]
    flat = [_to_i64(x.sum(0)).reshape(b, -1) for x in masked.values()]
    total = psum(torch.cat(flat, 1)[None], group)
    parts = torch.split(total, [f.shape[1] for f in flat], 1)
    return {name: _from_i64(part.reshape(x.shape[1:]), x)
            for (name, x), part in zip(masked.items(), parts)}


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


def packed_all_gather(payload: Payload, pending: torch.Tensor, cap: int, group=None
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
    records = all_gather_tree(dict(packed, _valid=valid), group)
    return records, records.pop("_valid"), sent


def packed_all_to_all(payload: Payload, dest: torch.Tensor, pending: torch.Tensor,
                      num_shards: int, cap: int, group=None
                      ) -> Tuple[Payload, torch.Tensor, torch.Tensor]:
    """Compacted sparse exchange, point to point: each shard ranks its
    pending lanes per destination, packs the first ``cap`` of each bucket
    into a (k_dst, cap, ...) send block, and one all-to-all swaps the
    buckets. Lanes past ``cap`` stay pending for the next round.

    Returns ``(arrivals, arr_valid, sent)``: leaves (k_dst, k_src, cap, ...)
    with [d, s] the records shard s addressed to d (zeros where invalid),
    ``arr_valid`` (k_dst, k_src, cap) and ``sent`` (k, P); over a group,
    k_dst is the rank's own row."""
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

    packed = dict({n: pack(x) for n, x in payload.items()}, _valid=pack(sent))
    if group is None:
        arrivals = {n: all_to_all(x) for n, x in packed.items()}
    else:
        arrivals = _fused(lambda x: all_to_all(x, group), packed, 2)
    return arrivals, arrivals.pop("_valid"), sent


# ---------------------------------------------------------------------------
# SPMD forms over a DeviceMesh axis
# ---------------------------------------------------------------------------


def local_mesh(num_devices: int, axis: str, device_type: str = "cuda"):
    """A one-axis ``DeviceMesh`` named ``axis`` over the first
    ``num_devices`` ranks of the default group, or None when there is no
    group or it has fewer ranks (the reference's None when the host has
    too few devices; callers then run the stacked form). ``device_type``
    "cuda" (the default) raises where there is no card. Every rank of the
    default group must call it; a rank past ``num_devices`` gets a mesh it
    is not in (``get_coordinate()`` is None)."""
    if not dist.is_initialized() or dist.get_world_size() < num_devices:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device_type).type
    return DeviceMesh(device_type, torch.arange(num_devices), mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """The device this rank works on for ``mesh``: its current card on a
    "cuda" mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _pmean(x: torch.Tensor, group, m: int) -> torch.Tensor:
    """``lax.pmean``: the sum over the group's ranks (in rank order),
    divided by their count."""
    return psum(x[None], group) / m


def hotness_sync_spmd(phi_in: torch.Tensor, phi_out: torch.Tensor, rows: torch.Tensor,
                      mesh, axis: str) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Average the sampled hotness rows (R,) across the ``axis`` replicas of
    ``mesh`` (each rank holds its own (N, d) float32 matrices) and write
    them back into both, in place. Returns (phi_in, phi_out, bytes moved:
    R * d * 4 B * m replicas * 2 matrices, the reference's figure)."""
    group, m = mesh.get_group(axis), int(mesh.size(mesh.mesh_dim_names.index(axis)))
    rows = rows.to(device=phi_in.device, dtype=torch.int64)
    phi_in[rows] = _pmean(phi_in[rows], group, m)
    phi_out[rows] = _pmean(phi_out[rows], group, m)
    nbytes = float(int(rows.shape[0]) * int(phi_in.shape[-1]) * 4 * m * 2)
    return phi_in, phi_out, nbytes


def compressed_allreduce(grad: torch.Tensor, error: torch.Tensor, ratio: float,
                         mesh, axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-|.| sparsified all-reduce with error feedback over the ``axis``
    ranks of ``mesh``: keep the entries of (grad + error) whose magnitude is
    at least the k-th largest (k = max(int(ratio * size), 1), ranked by a
    stable descending sort, ties to the lowest index, as ``lax.top_k``),
    ``pmean`` that sparse part and return (synced, residual). The sparse
    part plus the residual equals grad + error exactly."""
    acc = grad + error
    flat = acc.reshape(-1)
    k = max(int(ratio * flat.shape[0]), 1)
    thresh = torch.sort(torch.abs(flat), descending=True, stable=True).values[k - 1]
    mask = (torch.abs(flat) >= thresh).to(acc.dtype).reshape(acc.shape)
    sparse = acc * mask
    residual = acc - sparse
    group, m = mesh.get_group(axis), int(mesh.size(mesh.mesh_dim_names.index(axis)))
    return _pmean(sparse, group, m), residual
