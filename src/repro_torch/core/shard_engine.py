"""Partition-sharded BSP walk engine (paper §3: walker-centric + InCoM).

Walkers live on the shard that owns their current node under the MPGP
``assignment``. One superstep is:

  phase A (at owner(cur))   candidate draw + walking-backtracking
                            acceptance (``walker.propose``);
  exchange                  walkers whose accepted node belongs to another
                            shard pack the constant-size InCoM message and
                            hand off through a collective;
  phase B (at owner(cand))  n(v) from the local path fragment, Theorem 1 /
                            Eq. 13 update, path append, Eq. 5 termination
                            (``walker.absorb``).

Node v's visits are always appended on owner(v)'s fragment, so n(v) is a
local count and the walk itself never travels: only the 10-field, 80-byte
message does (Example 1). The corpus path is the elementwise union of the
fragments (each position is written by one shard). The fullpath (HuGE-D)
baseline ships the whole walk instead: 24 + 8L bytes, counted from the
path it routes. ``reg_window`` mode appends its K-entry ring (80 + 8K).
The message's ``steps`` field carries the sender's pre-step node, the
predecessor a second-order policy needs on arrival: the step count is the
superstep, known everywhere.

Two engines realize the per-shard program:

* **replicated** (``engine="auto"`` on one device): every shard reads the
  whole CSR and carries all B lanes; the exchange is the dense
  ``psum_union``. node2vec reads N(prev) and runs only here.
* **partition-local** (``engine="local"``): each shard indexes only its
  ``graph.csr.build_partitioned_csr`` slice (~|V|/k nodes, ~|E|/k arcs,
  with the neighbours' owners and degrees beside the arcs). Walker lanes
  sit in a per-shard pool of P slots (``pool_factor`` B / k, doubled and
  re-run on overflow); migrants ship as packed records (transports
  ``pool``, ``gather``, ``a2a``); a walker that leaves keeps its path
  fragment in place as a ghost slot, which it revives if it returns, and
  ghosts and finished walkers retire into lane-indexed stores once every
  ``compact_every`` supersteps.

Without a mesh the k shards are a leading axis of every tensor on one
device (``dist.collectives``: the reference's stacked ``vmap`` emulation).
With ``mesh`` (``make_walk_mesh``: k ranks of a ``torch.distributed``
group) each rank runs one shard, the reference's ``shard_map``: the same
code with a shard axis of length 1 and the collectives over the group.
Under the local engine a rank's device holds only its slice; under the
replicated one the whole CSR (the reference's ``P()``). Every rank then
all-gathers the per-shard outputs and merges them as the stacked driver
does, so every rank returns the stacked run's state bit for bit.
The reference's ``lax.while_loop`` conditions are host reads: the replicated
engine reads once a superstep, the local engine once a block of
``compact_every`` supersteps (supersteps after the last live walker are
frozen on the device, as the reference's are) and once per exchange round
under the ``gather`` and ``a2a`` transports, whose spill loop runs while a
shard has more than ``cap`` migrants queued. On a mesh each read is one
decision that all ranks share (``collectives.host_read``: the flags'
maximum over the ranks), as is the overflow retry's, so the ranks run the
same supersteps and rounds and double the pool together.

Arrivals claim slots in (source shard, record) order, and a returning
walker finds its ghost through a per-shard lane -> ghost-slot index built
by one scatter a round; the reference matches them with a dense
(P, k·cap) comparison, which at a million lanes would not fit a card. No
tensor here grows as P × k·cap or as k² × P (the ``a2a`` transport's
receive buffers are k² · cap records, the emulated mesh's k · cap a shard).

Per-lane RNG (the batch keys' ``uniforms``) and per-lane arithmetic do not
depend on the layout, so walks equal the dense engine's at every k and
under every transport. ``msg_count`` / ``msg_bytes`` come from the packed
message tensors the exchange moves: per hand-off, the field count of the
payload times 8 bytes a field (Example 1), so a packing change moves them
away from ``msg_bytes_analytic``, the closed form. Byte sums are float32,
as the reference's; counts are exact.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import incom
from repro_torch.core import walker as wk
from repro_torch.core.transition import Policy
from repro_torch.dist.collectives import (all_gather_tree, axis_index, host_read, local_mesh,
                                          mesh_device, packed_all_gather, packed_all_to_all,
                                          psum, psum_union, row_cumsum, take_ranked)
from repro_torch.graph.csr import (CSRGraph, PartitionedCSR, ShardCSR, build_partitioned_csr,
                                  reassign_partitioned_csr)
from repro_torch.graph.delta import graph_version

INFO_FIELDS = ("H", "L", "EH", "EL", "EHL", "EH2", "EL2")
AXIS = "shards"   # the walk-shard mesh axis
# Walk batches run on this engine, either engine (``chip_smoke.py`` reads it
# to show the k > 1 path walks here), and those of them run over a mesh, one
# shard a process (``SPMD_BATCHES``: a run that meant to be SPMD and took
# the stacked engine leaves it at 0).
BATCHES = 0
SPMD_BATCHES = 0


def make_walk_mesh(num_shards: int, device_type: str = "cuda"):
    """A ("shards",) ``DeviceMesh`` over the first ``num_shards`` ranks of
    the default group, or None when there is no group of that many ranks
    (callers then run the stacked engine, the same program)."""
    return local_mesh(num_shards, AXIS, device_type)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _bytes_each(spec: wk.WalkSpec) -> float:
    """Example 1's analytic bytes of one InCoM hand-off."""
    return float(incom.MSG_BYTES + 8 * spec.reg_window)


def _info_rows(info: incom.InfoState) -> torch.Tensor:
    return torch.stack([getattr(info, f) for f in INFO_FIELDS], -1)


def _info_of(rows: torch.Tensor) -> incom.InfoState:
    return incom.InfoState(**{f: rows[..., i] for i, f in enumerate(INFO_FIELDS)})


# ---------------------------------------------------------------------------
# Replicated engine: full-width lanes on every shard, dense union exchange
# ---------------------------------------------------------------------------


def _run_replicated(graph: CSRGraph, owner: torch.Tensor, sources: torch.Tensor,
                    keys: wk.Keys, policy: Policy, spec: wk.WalkSpec, k: int,
                    group=None) -> Dict:
    """One batch on the replicated engine: all k shards stacked, or over
    ``group`` this rank's shard (outputs with a leading axis of the shards
    held)."""
    b, dev = sources.shape[0], sources.device
    kl = k if group is None else 1                            # shards held here
    n, L = kl * b, spec.max_len
    fullpath = spec.info_mode == "fullpath"
    sid = axis_index(k, dev, group)                           # (kl, 1)
    ids = torch.arange(b, device=dev).repeat(kl)              # lane id of each (shard, lane)
    pos = torch.arange(L, device=dev)[None, :]
    step_cap = spec.supersteps_cap()

    resident = (owner[sources][None, :] == sid).reshape(n)
    cur = sources.repeat(kl)
    prev = cur.clone()
    active = torch.ones(n, dtype=torch.bool, device=dev)
    info = incom.InfoState.init(n, dev)
    # Fragment init: the source's first visit is recorded at its owner.
    path = torch.full((n, L), -1, dtype=torch.int32, device=dev)
    path[:, 0] = torch.where(resident, cur, -1).to(torch.int32)
    h = torch.zeros(n, spec.h_len(), device=dev)
    ring = torch.zeros(n, spec.ring_len(), device=dev)
    zeros = lambda dtype: torch.zeros(kl, dtype=dtype, device=dev)
    acc = {"accepts": zeros(torch.int64), "rejects": zeros(torch.int64),
           "msg_count": zeros(torch.int64), "msg_bytes": zeros(torch.float32),
           "msg_bytes_analytic": zeros(torch.float32)}
    t = reads = 0
    while t < step_cap:
        reads += 1
        if not host_read([(resident & active).any()], group)[0]:   # host sync
            break
        u1, u2 = keys.uniforms(t)
        cand, _, accept_raw, has_nbrs = wk.propose(graph, policy, cur, prev,
                                                   u1.repeat(kl), u2.repeat(kl))
        live = resident & active
        accept = live & accept_raw
        dead_end = live & ~has_nbrs
        mig = accept & (owner[cand].reshape(kl, b) != sid).reshape(n)
        stay = accept & ~mig
        if fullpath:
            # The HuGE-D message carries the walk including the accepted
            # node, so it is appended at the origin; phase B's append at
            # the same position is idempotent.
            idx = info.L.to(torch.int64).clamp(0, L - 1)
            path = torch.where(accept[:, None] & (pos == idx[:, None]),
                               cand.to(torch.int32)[:, None], path)

        # ---- pack + hand off (the measured exchange) ----------------------
        msg_i = torch.stack([ids, cur, cand], 1)
        msg_f = _info_rows(info)
        # "one" marks the lanes that arrived: a count of their senders.
        payload = {"i": msg_i, "f": msg_f, "one": torch.ones_like(ids)}
        if spec.reg_window:
            payload["ring"] = ring
        if fullpath:
            payload.update(path=path, h=h)
        arrivals = psum_union({name: x.reshape((kl, b) + x.shape[1:])
                               for name, x in payload.items()}, mig.reshape(kl, b), group)
        arr_i = arrivals["i"]
        arrived = arrivals["one"] > 0                                   # (B,)
        shipped_fields = msg_i.shape[1] + msg_f.shape[1] + (
            arrivals["ring"].shape[1] if spec.reg_window else 0)
        incoming = (arrived[None, :] & (owner[arr_i[:, 2]][None, :] == sid)).reshape(n)
        proc = stay | incoming

        # ---- merge arrivals into the local lane state ----------------------
        tiled = lambda x: x.repeat((kl,) + (1,) * (x.dim() - 1))
        sel = lambda a, o: torch.where(incoming.reshape((n,) + (1,) * (o.dim() - 1)),
                                       tiled(a), o)
        cand_b = sel(arr_i[:, 2], cand)
        sender_cur = sel(arr_i[:, 1], cur)
        info_b = _info_of(sel(arrivals["f"], msg_f))
        ring_b = sel(arrivals["ring"], ring) if spec.reg_window else ring
        path_b, h_b = ((sel(arrivals["path"], path), sel(arrivals["h"], h)) if fullpath
                       else (path, h))
        info2, path2, h, ring, done_now = wk.absorb(spec, info_b, path_b, h_b, ring_b,
                                                    cand_b, proc)

        resident = (resident & ~mig) | incoming
        cur = torch.where(proc, cand_b, cur)
        prev = torch.where(proc, sender_cur, prev)
        active = torch.where(proc, ~done_now, active & ~dead_end)

        # ---- measured + analytic traffic ----------------------------------
        per_shard = lambda x: x.reshape(kl, -1).sum(1)
        n_out = per_shard(mig.to(torch.int64))
        if fullpath:
            shipped = per_shard(((path >= 0) & mig[:, None]).to(torch.int64))
            add_meas = 8.0 * msg_i.shape[1] * _f32(n_out) + 8.0 * _f32(shipped)
            add_an = per_shard(torch.where(mig, incom.fullpath_msg_bytes(info.L + 1.0), 0.0))
        else:
            add_meas = float(8 * shipped_fields) * _f32(n_out)
            add_an = _bytes_each(spec) * _f32(n_out)
        info, path = info2, path2
        acc["accepts"] += per_shard(accept.to(torch.int64))
        acc["rejects"] += per_shard((live & has_nbrs & ~accept_raw).to(torch.int64))
        acc["msg_count"] += n_out
        acc["msg_bytes"] += add_meas
        acc["msg_bytes_analytic"] += add_an
        t += 1
    return dict(acc, cur=cur.reshape(kl, b), prev=prev.reshape(kl, b),
                resident=resident.reshape(kl, b), active=active.reshape(kl, b),
                info=_info_of(_info_rows(info).reshape(kl, b, -1)), path=path.reshape(kl, b, L),
                h=h.reshape(kl, b, -1), ring=ring.reshape(kl, b, -1), t=t, host_reads=reads)


def _merge(out: Dict, spec: wk.WalkSpec, keys: wk.Keys) -> wk.WalkerBatchState:
    """Combine the (k, ...) replicated-engine outputs into one state: every
    lane is resident on exactly one shard at the end."""
    res = out["resident"]
    return _combine(out, spec, keys, res, out["path"], out["cur"], out["prev"], out["info"],
                    out["h"], out["ring"], res & out["active"])


def _combine(out: Dict, spec: wk.WalkSpec, keys: wk.Keys, holder: torch.Tensor,
             path, cur, prev, info: incom.InfoState, h, ring, active) -> wk.WalkerBatchState:
    """One state from (k, B, ...) per-shard rows: each lane's scalars from
    the one shard that ``holder`` marks; its path from the union of the
    fragments, or in fullpath mode the holder's copy."""
    k, b = holder.shape
    at = holder.to(torch.int64).argmax(0)                     # the holding shard
    lanes = torch.arange(b, device=holder.device)
    pick = lambda x: x[at, lanes]
    if spec.info_mode == "fullpath":
        path = pick(path)
    else:
        path = path.max(0).values                             # each position: one writer
    return wk.WalkerBatchState(
        cur=pick(cur), prev=pick(prev), path=path,
        info=incom.InfoState(**{f: pick(getattr(info, f)) for f in INFO_FIELDS}),
        h_series=pick(h), hring=pick(ring), active=active.any(0), keys=keys,
        supersteps=out["t"], accepts=out["accepts"].sum(), rejects=out["rejects"].sum(),
        msg_count=out["msg_count"].sum(), msg_bytes=out["msg_bytes"].sum(),
        msg_bytes_analytic=out["msg_bytes_analytic"].sum())


# ---------------------------------------------------------------------------
# Partition-local engine: slot pools over the slices, packed sparse exchange
# ---------------------------------------------------------------------------


def _run_local(pcsr: PartitionedCSR, owner: torch.Tensor, sources: torch.Tensor,
               keys: wk.Keys, policy: Policy, spec: wk.WalkSpec, k: int, pool: int,
               cap: int, compact_every: int, transport: str, group=None) -> Dict:
    """One batch on the partition-local engine.

    Slot j of shard s holds the global lane id in ``lane[s, j]`` (-1 =
    free) and that walker's cur / prev / info / ring and its owner-local
    path row. Phase A reads only the shard's slice; migrants ship as
    packed records; arrivals claim free slots in (source shard, record)
    order. A walker that leaves keeps its slot as a ghost (its fragment
    stays), a finished one as a tombstone; one flush per block of
    ``compact_every`` supersteps retires both into the lane-indexed stores
    (one scatter each, with row B of every store taking the writes of the
    slots not retired) and packs the live slots to the front. A walker
    that finds no free slot counts in ``overflow``: the driver re-runs the
    batch with a doubled pool (at P = B none can overflow, since a lane
    holds at most one slot a shard).

    Stacked, ``pcsr.slices`` holds all k slices; over ``group`` it holds
    this rank's one, and every per-shard tensor has one row. The records
    then carry their fields through the collectives, and every host read
    is one decision that all ranks share (``host_read``)."""
    b, dev = sources.shape[0], sources.device
    p, L = pool, spec.max_len
    fullpath = spec.info_mode == "fullpath"
    shards, local_of = pcsr.slices, pcsr.local_of
    kl = shards.indptr.shape[0]                                # shards held here
    first = 0 if group is None else dist.get_rank(group)       # the first one's id
    max_nodes = shards.indptr.shape[1] - 1
    max_edges = shards.indices.shape[1]
    step_cap = spec.supersteps_cap()
    sid = axis_index(k, dev, group)                            # (kl, 1) shard ids
    rows = sid - first                                         # (kl, 1) rows here
    slot_id = sid * p + torch.arange(p, device=dev)            # flat (shard, slot) id
    store = b + 1                                              # lane-indexed rows + a spill row
    store_row = lambda lane_or_b: (rows * store + lane_or_b).reshape(-1)
    lpos = torch.arange(L, device=dev)[None, None, :]
    r_cap = p if transport == "pool" else cap
    counts = {"host_reads": 0, "exchange_rounds": 0, "spill_rounds": 0}
    zk = lambda dtype: torch.zeros(kl, dtype=dtype, device=dev)
    flat = lambda x: x.reshape((kl * p,) + x.shape[2:])
    shaped = lambda x: x.reshape((kl, p) + x.shape[1:])

    # ---- pool init: resident source lanes claim slots in lane order -------
    resident0 = owner[sources][None, :] == sid                 # (kl, B)
    packed, valid0 = take_ranked({"lane": torch.arange(b, device=dev).expand(kl, b)},
                                 resident0, p)
    lane0 = torch.where(valid0, packed["lane"], -1)
    occ0 = lane0 >= 0
    cur0 = torch.where(occ0, sources[lane0.clamp_min(0)], 0)
    prow0 = torch.full((kl, p, L), -1, dtype=torch.int32, device=dev)
    prow0[:, :, 0] = torch.where(occ0, cur0, -1).to(torch.int32)
    info0 = incom.InfoState.init(kl * p, dev)
    st = dict(lane=lane0, alive=occ0, term=torch.zeros_like(occ0), cur=cur0, prev=cur0,
              info=incom.InfoState(**{f: shaped(getattr(info0, f)) for f in INFO_FIELDS}),
              ring=torch.zeros(kl, p, spec.ring_len(), device=dev),
              h=torch.zeros(kl, p, spec.h_len(), device=dev), prow=prow0,
              t=torch.zeros((), dtype=torch.int64, device=dev),
              accepts=zk(torch.int64), rejects=zk(torch.int64), msg_count=zk(torch.int64),
              msg_bytes=zk(torch.float32), msg_bytes_analytic=zk(torch.float32),
              overflow=(resident0.sum(1) - p).clamp_min(0), peak_occ=occ0.sum(1))
    fin_info0 = incom.InfoState.init(kl * store, dev)
    fin = dict(cur=torch.zeros(kl, store, dtype=torch.int64, device=dev),
               prev=torch.zeros(kl, store, dtype=torch.int64, device=dev),
               info=incom.InfoState(**{f: getattr(fin_info0, f).clone().reshape(kl, store)
                                       for f in INFO_FIELDS}),
               ring=torch.zeros(kl, store, spec.ring_len(), device=dev),
               h=torch.zeros(kl, store, spec.h_len(), device=dev),
               valid=torch.zeros(kl, store, dtype=torch.bool, device=dev),
               active=torch.zeros(kl, store, dtype=torch.bool, device=dev),
               # The owner-local path fragments (the travelling walk in fullpath mode).
               path=torch.full((kl, store, L), -1, dtype=torch.int32, device=dev))
    ghost_of = torch.full((kl * store,), -1, dtype=torch.int64, device=dev)

    def flush_into(st, mask, active_mask):
        """Retire ``mask`` slots into the lane-indexed stores: their path
        rows (the fragment; in fullpath mode only a finished walk's), and
        for a finished or (``active_mask``) live walker its final state."""
        lane = st["lane"]
        srows = store_row(torch.where(mask, lane, b))
        mfin = mask & (st["term"] | active_mask)
        frows = store_row(torch.where(mfin, lane, b))
        fin["path"].view(kl * store, L)[frows if fullpath else srows] = flat(st["prow"])
        fin["cur"].view(-1)[frows] = flat(st["cur"])
        fin["prev"].view(-1)[frows] = flat(st["prev"])
        for f in INFO_FIELDS:
            getattr(fin["info"], f).view(-1)[frows] = flat(getattr(st["info"], f))
        fin["ring"].view(kl * store, -1)[frows] = flat(st["ring"])
        fin["h"].view(kl * store, -1)[frows] = flat(st["h"])
        fin["valid"].view(-1)[frows] = True
        fin["active"].view(-1)[store_row(torch.where(mask & active_mask, lane, b))] = True

    def flush_and_repack(st):
        """Retire ghosts and tombstones, then pack the live slots to the
        front of each pool."""
        nonlive = (st["lane"] >= 0) & ~st["alive"]
        flush_into(st, nonlive, torch.zeros_like(nonlive))
        lane = torch.where(nonlive, -1, st["lane"])
        live = lane >= 0
        got, pv = take_ranked({"lane": lane, "cur": st["cur"], "prev": st["prev"],
                               "info": _info_rows(st["info"]), "ring": st["ring"],
                               "h": st["h"], "prow": st["prow"]}, live, p)
        keep = lambda x, fill: torch.where(pv.reshape(pv.shape + (1,) * (x.dim() - 2)),
                                           x, fill)
        st.update(lane=keep(got["lane"], -1), alive=pv, term=torch.zeros_like(pv),
                  cur=keep(got["cur"], 0), prev=keep(got["prev"], 0),
                  info=_info_of(keep(got["info"], 0.0)), ring=keep(got["ring"], 0.0),
                  h=keep(got["h"], 0.0), prow=keep(got["prow"], -1))

    def exchange_round(c, pay, ship_sz):
        """One round of the packed exchange: ship up to ``cap`` pending
        migrants a shard (all under the pool transport), deliver each
        record to the owner of its candidate, revive returning walkers'
        ghosts and place first arrivals in free slots. Stacked, the
        collectives move each record as its sender's slot id and a
        receiver reads the record's fields from the senders' stacked
        payload ``pay`` by it, which on one device stands for the wire;
        over a group the fields travel with the record."""
        pending = c["pending"]
        ship = {"slot": slot_id} if group is None else dict(pay, slot=slot_id)
        if transport == "a2a":
            arr, arr_valid, sent = packed_all_to_all(ship, c["dest"], pending, k, r_cap, group)
            rec_dest = sid.expand(kl, k * r_cap).reshape(-1)  # row d arrived at d
        elif transport == "gather":
            arr, arr_valid, sent = packed_all_gather(ship, pending, r_cap, group)
        else:
            # Flat pool transport: the P-wide payload travels masked, so
            # one round always delivers every migrant.
            sent = pending
            arr = all_gather_tree(dict(ship, _valid=pending), group)
            arr_valid = arr.pop("_valid")
        rec_slot, rec_valid = arr["slot"].reshape(-1), arr_valid.reshape(-1)
        n_rec = rec_slot.shape[0]
        if group is None:
            records = lambda name: flat(pay[name])[rec_slot]
            fetch = lambda name, ri: flat(pay[name])[rec_slot[ri]]
        else:
            records = lambda name: arr[name].reshape((n_rec,) + arr[name].shape[-1:])
            fetch = lambda name, ri: records(name)[ri]
        rec_i = records("i")
        if transport != "a2a":
            # Receivers filter the broadcast records by the candidate's owner.
            rec_dest = owner[rec_i[:, 2]]
        rec_lane = rec_i[:, 0]
        # Each record's row here (kl: addressed to a shard held elsewhere).
        mine = rec_valid & (rec_dest >= first) & (rec_dest < first + kl)
        rec_row = torch.where(mine, rec_dest - first, kl)

        rrec = torch.full((kl * p + 1,), -1, dtype=torch.int64, device=dev)
        if fullpath:
            # The walk left with its walker; the sender's slot frees.
            lane1 = torch.where(sent, -1, c["lane"])
            revive = torch.zeros_like(rec_valid)
        else:
            # A sender's slot stays as a ghost holding its fragment; a
            # returning walker revives its own ghost in place, which keeps
            # a shard at one slot a lane. The lane -> ghost-slot index is
            # one scatter, read at each record's destination, then undone.
            lane1 = c["lane"]
            ghost = (lane1 >= 0) & ~c["alive"] & ~c["term"]
            grows = store_row(torch.where(ghost, lane1, b))
            ghost_of[grows] = slot_id.remainder(p).reshape(-1)
            g = ghost_of[rec_row.clamp(max=kl - 1) * store + rec_lane.clamp_min(0)]
            ghost_of[grows] = -1
            revive = mine & (g >= 0)
            rrec[torch.where(revive, rec_row.clamp(max=kl - 1) * p + g, kl * p)] = \
                torch.arange(n_rec, device=dev)
        rrec = rrec[:kl * p].reshape(kl, p)
        revived = rrec >= 0
        # First arrivals: the r-th free slot (ascending) of shard d takes the
        # r-th record addressed to d that revived nothing, in record order.
        key = torch.where(mine & ~revive, rec_row, kl)
        order = torch.sort(key, stable=True).indices
        n_mine = torch.zeros(kl + 1, dtype=torch.int64, device=dev).index_add_(
            0, key, torch.ones_like(key))[:kl]
        starts = torch.cumsum(n_mine, 0) - n_mine
        free = lane1 < 0
        free_rank = row_cumsum(free) - 1
        takes = free & (free_rank < n_mine[:, None])
        rec_idx = order[(starts[:, None] + free_rank).clamp(0, n_rec - 1)]
        place = takes | revived
        ri = torch.where(revived, rrec, rec_idx)                 # (kl, P) records placed
        t_i = fetch("i", ri)
        if fullpath:
            prow1 = torch.where(takes[..., None], fetch("path", ri), c["prow"])
        else:
            # A first visit's (or post-flush return's) fragment comes from
            # the lane-indexed store; a revived slot's is already in place.
            t_lane = torch.where(takes, t_i[..., 0], 0)
            prow1 = torch.where(takes[..., None], fin["path"].view(kl * store, L)[
                store_row(t_lane)].reshape(kl, p, L), c["prow"])
        put = lambda a, o: torch.where(place.reshape(place.shape + (1,) * (o.dim() - 2)), a, o)
        n_sent = sent.sum(1)
        if fullpath:
            add_meas = 8.0 * pay["i"].shape[2] * _f32(n_sent) + \
                8.0 * _f32(torch.where(sent, ship_sz, 0).sum(1))
        else:
            add_meas = float(8 * c["fields"]) * _f32(n_sent)
        return dict(
            c, pending=pending & ~sent,
            lane=torch.where(takes, t_i[..., 0], lane1),
            alive=(c["alive"] & ~sent) | place,
            term=c["term"] & ~place,
            cur=put(t_i[..., 1], c["cur"]),
            prev=put(t_i[..., 1], c["prev"]),
            info=_info_of(put(fetch("f", ri), _info_rows(c["info"]))),
            ring=put(fetch("ring", ri), c["ring"]) if spec.reg_window else c["ring"],
            h=put(fetch("h", ri), c["h"]) if fullpath else c["h"],
            prow=prow1,
            proc=c["proc"] | place,
            pcand=put(t_i[..., 2], c["pcand"]),
            overflow=c["overflow"] + (n_mine - free.sum(1)).clamp_min(0),
            msg_count=c["msg_count"] + n_sent,
            msg_bytes=c["msg_bytes"] + add_meas)

    def superstep(st, t_host: int):
        """One BSP superstep. Once no walker lives (or the cap is reached)
        it changes nothing and ``t`` stays. Returns the new state and the
        device flag of whether it stepped."""
        lane, info = st["lane"], st["info"]
        occ = (lane >= 0) & st["alive"]                        # ghosts/tombstones don't walk
        stepping = (psum(occ.sum(1), group) > 0) & (st["t"] < step_cap)
        u1f, u2f = keys.uniforms(t_host)
        ls = lane.clamp_min(0)
        u1, u2 = u1f[ls], u2f[ls]

        # ---- phase A on the local slice ------------------------------------
        cur = st["cur"]
        cur_l = local_of[cur].clamp(0, max_nodes - 1)
        start = shards.take("indptr", cur_l).to(torch.int64)
        deg = _f32(shards.take("indptr", cur_l + 1).to(torch.int64) - start)
        deg = torch.where(occ, deg, 0.0)                       # free slots are stale
        has_nbrs = deg > 0
        j = torch.minimum((u1 * deg).to(torch.int64), (deg.to(torch.int64) - 1).clamp_min(0))
        eidx = (start + j).clamp(0, max_edges - 1)
        cand = shards.take("indices", eidx).to(torch.int64)
        cand_owner = shards.take("nbr_owner", eidx).to(torch.int64)   # the halo's owner()
        p_acc = policy.accept_prob_local(shards, st["prev"], cur_l, cand, eidx)
        accept_raw = has_nbrs & (u2 < p_acc)
        accept = occ & accept_raw & stepping
        dead_end = occ & ~has_nbrs & stepping
        mig = accept & (cand_owner != sid)
        stay = accept & ~mig

        prow, ship_sz = st["prow"], None
        if fullpath:
            # The message carries the walk including the accepted node.
            idx = info.L.to(torch.int64).clamp(0, L - 1)
            prow = torch.where(accept[..., None] & (lpos == idx[..., None]),
                               cand.to(torch.int32)[..., None], prow)
            ship_sz = (prow >= 0).sum(2)

        # ---- packed sparse exchange -----------------------------------------
        pay = {"i": torch.stack([lane, cur, cand], -1), "f": _info_rows(info)}
        if spec.reg_window:
            pay["ring"] = st["ring"]
        if fullpath:
            pay.update(path=prow, h=st["h"])
        n_mig = mig.sum(1)
        if fullpath:
            add_an = torch.where(mig, incom.fullpath_msg_bytes(info.L + 1.0), 0.0).sum(1)
        else:
            add_an = _bytes_each(spec) * _f32(n_mig)
        c = dict(pending=mig, dest=cand_owner, lane=lane, alive=st["alive"], term=st["term"],
                 cur=cur, prev=st["prev"], info=info, ring=st["ring"], h=st["h"], prow=prow,
                 proc=stay, pcand=cand, overflow=zk(torch.int64), msg_count=zk(torch.int64),
                 msg_bytes=zk(torch.float32),
                 fields=pay["i"].shape[2] + pay["f"].shape[2]
                 + (pay["ring"].shape[2] if spec.reg_window else 0))
        # The first round runs unread: with nothing pending it changes
        # nothing, as the reference's loop that would not have entered.
        c = exchange_round(c, pay, ship_sz)
        counts["exchange_rounds"] += 1
        stepped = None
        if transport != "pool":
            # Spill rounds, while some shard has more than ``cap`` queued.
            while True:
                more, stepped = host_read([c["pending"].any(), stepping], group)
                counts["host_reads"] += 1
                if not more:
                    break
                c = exchange_round(c, pay, ship_sz)
                counts["exchange_rounds"] += 1
                counts["spill_rounds"] += 1

        # ---- phase B on the compacted pool ----------------------------------
        lane_x, proc, pcand = c["lane"], c["proc"], c["pcand"]
        info2, path2, h2, ring2, done_now = wk.absorb(
            spec, incom.InfoState(**{f: flat(getattr(c["info"], f)) for f in INFO_FIELDS}),
            flat(c["prow"]), flat(c["h"]), flat(c["ring"]), flat(pcand), flat(proc))
        done = (proc & shaped(done_now)) | dead_end
        st = dict(
            st, lane=lane_x,
            # A finished walker tombstones: its state freezes in the pool and
            # retires to the stores at the next flush.
            alive=c["alive"] & (lane_x >= 0) & ~done,
            term=c["term"] | done,
            cur=torch.where(proc, pcand, c["cur"]), prev=torch.where(proc, c["cur"], c["prev"]),
            info=incom.InfoState(**{f: shaped(getattr(info2, f)) for f in INFO_FIELDS}),
            ring=shaped(ring2), h=shaped(h2), prow=shaped(path2),
            t=st["t"] + stepping.to(torch.int64),
            accepts=st["accepts"] + accept.sum(1),
            rejects=st["rejects"] + (occ & has_nbrs & ~accept_raw & stepping).sum(1),
            msg_count=st["msg_count"] + c["msg_count"],
            msg_bytes=st["msg_bytes"] + c["msg_bytes"],
            msg_bytes_analytic=st["msg_bytes_analytic"] + add_an,
            overflow=st["overflow"] + c["overflow"],
            peak_occ=torch.maximum(st["peak_occ"], (lane_x >= 0).sum(1)))
        return st, stepped

    while True:
        live, t0, overflow = host_read([((st["lane"] >= 0) & st["alive"]).any(), st["t"],
                                        st["overflow"].sum()], group)
        counts["host_reads"] += 1
        if overflow or not (live and t0 < step_cap):
            break        # an overflowed run is run again with a larger pool: stop it here
        # ``compact_every`` supersteps, then one flush and repack. A stepping
        # superstep has t == t0 + i, so the host knows each one's draws.
        for i in range(max(compact_every, 1)):
            st, stepped = superstep(st, t0 + i)
            if stepped == 0:             # the walk ended: the rest of the block is idle
                break
        flush_and_repack(st)

    # ---- final flush: ghosts, tombstones and still-live lanes ---------------
    filled = st["lane"] >= 0
    flush_into(st, filled, st["alive"])
    return dict(st, fin=fin, occ_final=filled.sum(1), t=int(st["t"]), **counts)


def _merge_local(out: Dict, spec: wk.WalkSpec, keys: wk.Keys) -> wk.WalkerBatchState:
    """Combine the (k, ...) partition-local outputs into one state: each
    lane retired (or was flushed live) on exactly one shard, the one whose
    ``valid`` row is set."""
    fin = out["fin"]
    b = fin["valid"].shape[1] - 1
    lanes = lambda x: x[:, :b]
    fv = lanes(fin["valid"])
    info = incom.InfoState(**{f: lanes(getattr(fin["info"], f)) for f in INFO_FIELDS})
    return _combine(out, spec, keys, fv, lanes(fin["path"]), lanes(fin["cur"]),
                    lanes(fin["prev"]), info, lanes(fin["h"]), lanes(fin["ring"]),
                    fv & lanes(fin["active"]))


# ---------------------------------------------------------------------------
# SPMD drivers: one shard a rank, over the mesh's group
# ---------------------------------------------------------------------------

# The per-shard outputs each merge reads (and ``_shard_stats``).
_REPLICATED_OUT = ("cur", "prev", "resident", "active", "info", "path", "h", "ring", "accepts",
                   "rejects", "msg_count", "msg_bytes", "msg_bytes_analytic")
_LOCAL_OUT = ("fin", "accepts", "rejects", "msg_count", "msg_bytes", "msg_bytes_analytic",
              "overflow", "peak_occ", "occ_final")


def _gathered(out: Dict, names, group) -> Dict:
    """``out`` with the per-shard outputs ``names`` all-gathered from
    (1, ...) to (k, ...) in one collective, as the reference's
    ``out_specs=P(AXIS)`` returns them; host-side values (``t``, the
    counts) are the same on every rank."""
    flat = {}
    for name in names:
        x = out[name]
        for sub, v in (x.items() if isinstance(x, dict) else [("", x)]):
            flat[f"{name}/{sub}"] = _info_rows(v) if isinstance(v, incom.InfoState) else v
    got = all_gather_tree(flat, group)
    res = dict(out)
    for key, v in got.items():
        name, sub = key.split("/")
        like = out[name][sub] if sub else out[name]
        v = _info_of(v) if isinstance(like, incom.InfoState) else v
        if sub:
            res[name] = dict(res[name]) if res[name] is out[name] else res[name]
            res[name][sub] = v
        else:
            res[name] = v
    return res


def _run_spmd(graph: CSRGraph, owner, sources, keys, policy, spec, k: int, mesh) -> Dict:
    """The replicated engine, this rank's shard of ``mesh``: the whole CSR
    on every rank, all B lanes, the dense union exchange over the group."""
    group = mesh.get_group(AXIS)
    out = _run_replicated(graph, owner, sources, keys, policy, spec, k, group=group)
    return _gathered(out, _REPLICATED_OUT, group)


def _run_spmd_local(pcsr: PartitionedCSR, owner, sources, keys, policy, spec, k: int, mesh,
                    pool: int, cap: int, compact_every: int, transport: str) -> Dict:
    """The partition-local engine, this rank's shard of ``mesh`` (``pcsr``
    holds its one slice). An overflow is one decision of all ranks: it
    returns the overflow alone, and every rank re-runs with a doubled pool."""
    group = mesh.get_group(AXIS)
    out = _run_local(pcsr, owner, sources, keys, policy, spec, k, pool, cap, compact_every,
                     transport, group=group)
    (over,) = host_read([out["overflow"].sum()], group)
    if over:
        return {"overflow": torch.tensor([over])}
    return _gathered(out, _LOCAL_OUT, group)


_SLICE_CACHE: Dict = {}


def rank_slice(graph: CSRGraph, assignment: np.ndarray, num_shards: int, rank: int,
               device, key_obj: object = None) -> PartitionedCSR:
    """Shard ``rank``'s partition-local store on ``device``: one ``ShardCSR``
    row (the slice is cut on the host, so the device never holds the
    others) with the replicated node metadata. Memoized like
    ``partitioned_csr_for``."""
    key_obj = graph if key_obj is None else key_obj
    asn = np.asarray(assignment)
    dev = torch.device(device)
    key = (id(key_obj), graph_version(key_obj), num_shards, graph.edge_cm is not None,
           hash(asn.tobytes()), rank, str(dev))
    hit = _SLICE_CACHE.get(key)
    if hit is not None and hit[0]() is key_obj:
        return hit[1]
    full = build_partitioned_csr(graph.to("cpu"), asn, num_shards)
    cut = {f.name: getattr(full.slices, f.name) for f in dataclasses.fields(ShardCSR)}
    one = ShardCSR(**{name: None if t is None else t[rank:rank + 1].to(dev, copy=True)
                      for name, t in cut.items()})
    pcsr = PartitionedCSR(slices=one, local_of=full.local_of.to(dev), owned=full.owned,
                          num_owned=full.num_owned, num_parts=num_shards)
    if len(_SLICE_CACHE) >= 8:
        _SLICE_CACHE.clear()
    _SLICE_CACHE[key] = (weakref.ref(key_obj), pcsr)
    return pcsr


def _shard_stats(out: Dict, k: int, pcsr: Optional[PartitionedCSR], pool: Optional[int],
                 cap: Optional[int], retries: int) -> Dict:
    """Per-shard balance, occupancy and traffic, and the host reads and
    exchange rounds the run took."""
    stats: Dict = {"supersteps": [out["t"]] * k,
                   "msg_count": out["msg_count"].cpu().numpy().astype(int).tolist(),
                   "host_reads": out["host_reads"]}
    if "peak_occ" in out:
        stats.update(
            peak_lane_occupancy=out["peak_occ"].cpu().numpy().astype(int).tolist(),
            final_lane_occupancy=out["occ_final"].cpu().numpy().astype(int).tolist(),
            pool_slots=pool, exchange_cap=cap, pool_retries=retries,
            exchange_rounds=out["exchange_rounds"], spill_rounds=out["spill_rounds"])
    if pcsr is not None:
        stats["owned_nodes"] = pcsr.num_owned.astype(int).tolist()
        stats["csr_bytes_per_shard"] = pcsr.shard_csr_nbytes().astype(int).tolist()
    # Everything above is on the host already: exporting it reads nothing
    # more back from the device.
    if obs.enabled():
        obs.inc("walk.supersteps", float(np.sum(stats["supersteps"])))
        obs.inc("walk.msg_count", float(np.sum(stats["msg_count"])))
        if "peak_lane_occupancy" in stats:
            obs.set_gauges("walk.peak_occ", stats["peak_lane_occupancy"])
            obs.set_gauge("walk.pool_slots", stats["pool_slots"])
            obs.inc("walk.pool_retries", stats["pool_retries"])
        if "csr_bytes_per_shard" in stats:
            obs.set_gauges("walk.csr_bytes", stats["csr_bytes_per_shard"])
    return stats


# ---------------------------------------------------------------------------
# Caches and the public driver
# ---------------------------------------------------------------------------

# Both caches key on the caller's graph object by identity and its mutation
# version (``graph.delta.graph_version``: the delta overlay bumps a view it
# retires), and hold the object by weakref, so a dropped graph's slices free
# with it, a recycled id() never aliases, and a mutated graph is never served
# the slices or the pool size of its former contents.
_PCSR_CACHE: Dict = {}
_POOL_CACHE: Dict = {}


def partitioned_csr_for(graph: CSRGraph, assignment: np.ndarray, num_shards: int,
                        key_obj: object = None) -> PartitionedCSR:
    """Memoized ``build_partitioned_csr``: the slicing is O(|E|) host work
    and the engine runs once per walk batch of every round. ``key_obj`` is
    the object whose identity keys the entry: pass the caller's graph
    when ``graph`` is a derived copy (``with_edge_cm()`` makes a new one)."""
    key_obj = graph if key_obj is None else key_obj
    asn = np.asarray(assignment)
    key = (id(key_obj), graph_version(key_obj), num_shards, graph.edge_cm is not None,
           hash(asn.tobytes()))
    hit = _PCSR_CACHE.get(key)
    if hit is not None and hit[0]() is key_obj:
        return hit[1]
    pcsr = build_partitioned_csr(graph, asn, num_shards)
    if len(_PCSR_CACHE) >= 8:
        _PCSR_CACHE.clear()
    _PCSR_CACHE[key] = (weakref.ref(key_obj), pcsr)
    return pcsr


def reconfigure_partitions(graph: CSRGraph, old_assignment: np.ndarray,
                           new_assignment: np.ndarray, num_shards_new: int, *,
                           old_of_new: np.ndarray, num_shards_old: Optional[int] = None,
                           key_obj: object = None) -> Dict:
    """Swap the cached partition-local store to a new shard layout after an
    elastic reconfiguration: a k -> k-1 shard death (``num_shards_old``
    defaults to ``num_shards_new + 1``) or a k -> k+1 re-join (pass
    ``num_shards_old``, and -1 in ``old_of_new`` for the returned shard).

    The old store is looked up in ``_PCSR_CACHE``; when it is there (the
    engine built it in an earlier round) the new one is assembled by
    ``reassign_partitioned_csr``, the untouched shards' arc rows copied on
    the device, else built afresh. Every entry keyed on the replaced
    assignment, slices and learned pool sizes alike, is evicted (a k-way
    pool size says nothing of k±1), and the new store is primed under the
    new assignment's key, so the next walk round hits. Returns
    ``{"reused_shards", "rebuilt_shards", "wall_s"}``."""
    t0 = time.perf_counter()
    key_obj = graph if key_obj is None else key_obj
    old_asn = np.asarray(old_assignment)
    new_asn = np.asarray(new_assignment)
    gv = graph_version(key_obj)
    k_old = num_shards_new + 1 if num_shards_old is None else int(num_shards_old)
    h_old = hash(old_asn.tobytes())

    # Reuse needs like-for-like rows: match the store's weights and Cm to
    # the graph being sliced (the key's Cm flag names the slicing graph,
    # which ``run_walk_sharded`` may have given Cm).
    old_pcsr = None
    for key, (ref, pcsr) in list(_PCSR_CACHE.items()):
        if (key[0] == id(key_obj) and key[1] == gv and key[2] == k_old and key[4] == h_old
                and ref() is key_obj
                and (pcsr.slices.edge_cm is not None) == (graph.edge_cm is not None)
                and (pcsr.slices.weights is not None) == (graph.weights is not None)):
            old_pcsr = pcsr
            break
    if old_pcsr is not None:
        new_pcsr, reused = reassign_partitioned_csr(graph, new_asn, num_shards_new, old=old_pcsr,
                                                    old_assignment=old_asn,
                                                    old_of_new=np.asarray(old_of_new))
    else:
        new_pcsr, reused = build_partitioned_csr(graph, new_asn, num_shards_new), 0

    # The keys: (id, version, k, Cm, assignment hash) for slices and
    # (id, version, k, B, spec, pool factor, assignment hash) for pools.
    for key in [k for k in _PCSR_CACHE if k[0] == id(key_obj) and k[4] == h_old]:
        del _PCSR_CACHE[key]
    for key in [k for k in _POOL_CACHE if k[0] == id(key_obj) and k[-1] == h_old]:
        del _POOL_CACHE[key]
    if len(_PCSR_CACHE) >= 8:
        _PCSR_CACHE.clear()
    new_key = (id(key_obj), gv, num_shards_new, graph.edge_cm is not None,
               hash(new_asn.tobytes()))
    _PCSR_CACHE[new_key] = (weakref.ref(key_obj), new_pcsr)
    if graph.device.type == "cuda":
        torch.cuda.synchronize(graph.device)
    return {"reused_shards": int(reused), "rebuilt_shards": int(num_shards_new - reused),
            "wall_s": float(time.perf_counter() - t0)}


def run_walk_sharded(graph: CSRGraph, sources: torch.Tensor, keys: wk.Keys,
                     policy: Policy, spec: wk.WalkSpec, assignment, num_shards: int,
                     mesh=None, *, engine: str = "auto", pool_factor: float = 2.0,
                     exchange_cap: Optional[int] = None, compact_every: int = 8,
                     transport: Optional[str] = None, with_stats: bool = False):
    """Run one walk per source on ``num_shards`` partition shards.
    ``assignment`` maps node -> shard (MPGP's).

    With ``mesh`` (``make_walk_mesh(num_shards)``, called on every rank)
    each rank runs its shard on the mesh's device and returns the merged
    state of all of them; otherwise the k shards run stacked on the
    graph's device. The walks are bit for bit the same either way.

    ``engine``: ``"replicated"`` (every shard on the whole CSR, all lanes),
    ``"local"`` (partition-local slices, slot pools, packed exchange; for
    policies with ``supports_partition_local``) or ``"auto"``, as in the
    reference: local on a mesh when the policy supports it, else
    replicated (on one device the k programs run one after another and
    there is no memory to save). ``pool_factor`` is the gamma of the MPGP
    balance bound that sizes each shard's pool (gamma B / k slots, doubled
    and re-run on overflow, the size remembered); ``exchange_cap`` bounds
    the records a shard ships per round (per destination under ``a2a``;
    default P / 8, at least 8); ``transport`` picks ``"gather"`` (the
    stacked default), ``"a2a"`` (the mesh default) or ``"pool"``. Walks
    are the same under every engine, shard count and transport.
    ``with_stats=True`` also returns the per-shard stats dict."""
    global BATCHES, SPMD_BATCHES
    BATCHES += 1
    use_mesh = mesh is not None and int(mesh.size()) == num_shards
    if use_mesh:
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is not in the walk mesh")
        SPMD_BATCHES += 1
        dev = mesh_device(mesh)
    else:
        dev = graph.device
    sources = torch.as_tensor(sources, device=dev).to(torch.int64)
    asn = np.asarray(assignment)
    owner = torch.as_tensor(asn, device=dev).to(torch.int64)
    graph_key = graph                   # the caches key on the caller's object
    if policy.needs_edge_cm and graph.edge_cm is None:
        graph = graph.with_edge_cm()
    if engine == "auto":
        engine = "local" if use_mesh and policy.supports_partition_local else "replicated"
    if engine == "replicated":
        if use_mesh:
            out = _run_spmd(graph.to(dev), owner, sources, keys, policy, spec, num_shards, mesh)
        else:
            out = _run_replicated(graph, owner, sources, keys, policy, spec, num_shards)
        state = _merge(out, spec, keys)
        return (state, _shard_stats(out, num_shards, None, None, None, 0)) if with_stats \
            else state
    if engine != "local":
        raise ValueError(f"unknown engine {engine!r}")
    if not policy.supports_partition_local:
        raise ValueError(
            f"{type(policy).__name__} cannot run partition-local (it reads "
            "non-local CSR rows); use engine='replicated'")
    if transport is None:
        transport = "a2a" if use_mesh else "gather"
    if transport not in ("pool", "gather", "a2a"):
        raise ValueError(f"unknown transport {transport!r}")

    if use_mesh:
        pcsr = rank_slice(graph, asn, num_shards, mesh.get_coordinate()[0], dev,
                          key_obj=graph_key)
    else:
        pcsr = partitioned_csr_for(graph, asn, num_shards, key_obj=graph_key)
    b = int(sources.shape[0])
    init_occ = np.bincount(asn[sources.cpu().numpy()], minlength=num_shards) if b \
        else np.zeros(1, np.int64)
    pool = min(b, max(math.ceil(pool_factor * b / max(num_shards, 1)), int(init_occ.max()), 1))
    pool_key = (id(graph_key), graph_version(graph_key), num_shards, b, spec,
                float(pool_factor), hash(asn.tobytes()))
    hit = _POOL_CACHE.get(pool_key)
    if hit is not None and hit[0]() is graph_key:
        pool = max(pool, hit[1])
    cap = int(exchange_cap) if exchange_cap else max(8, pool // 8)
    retries = 0
    t0 = time.perf_counter() if obs.enabled() else 0.0
    while True:
        if use_mesh:
            out = _run_spmd_local(pcsr, owner, sources, keys, policy, spec, num_shards, mesh,
                                  pool, cap, compact_every, transport)
        else:
            out = _run_local(pcsr, owner, sources, keys, policy, spec, num_shards, pool, cap,
                             compact_every, transport)
        if int(out["overflow"].sum()) == 0:
            break
        # Walkers piled onto one shard beyond gamma B / k: double the pool
        # and run again. At pool == B no overflow is possible.
        if pool >= b:
            raise RuntimeError("a slot pool of B slots overflowed")
        pool = min(b, pool * 2)
        retries += 1
    if retries:
        if len(_POOL_CACHE) >= 64:
            _POOL_CACHE.clear()
        _POOL_CACHE[pool_key] = (weakref.ref(graph_key), pool)
    if obs.enabled():
        # The overflow check above read the run back: this wall is the
        # device's time, not the enqueue's.
        obs.observe("walk.batch_dispatch.s", time.perf_counter() - t0)
        obs.inc("walk.engine_batches")
        obs.inc("walk.spill_retries", retries)
        obs.set_gauge("walk.pool_slots", pool)
    state = _merge_local(out, spec, keys)
    return (state, _shard_stats(out, num_shards, pcsr, pool, cap, retries)) if with_stats \
        else state
