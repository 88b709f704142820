"""Walk corpus: device-resident ring + frequency relabeling (§4.2-I).

Finished walk batches are appended into a ``CorpusRing`` on the device:
paths land in ring slots, per-node occurrence counts (``ocn``, the input
of Eq. 6/7) accumulate by a scatter-add. The streaming trainer gathers
training lifetimes from ring slots directly, so walks never leave the
device between the sampler and the learner.

The ring is updated in place. Its write cursor and walk total are host
integers: they are known without reading the device back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.termination import WalkCountController
from repro_torch.core.transition import Policy
from repro_torch.core.walker import (MAX_LANES, REF_CHUNK, LaneKeys, VertexKeys, WalkSpec,
                                    batch_stats, run_walk_batch)
from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class Corpus:
    walks: np.ndarray        # (num_walks, max_len) int32, -1 padded
    lengths: np.ndarray      # (num_walks,) int64
    ocn: np.ndarray          # (|V|,) int64 — occurrences per node
    rounds: int
    stats: Dict[str, float]

    @property
    def num_walks(self) -> int:
        return int(self.walks.shape[0])


@dataclasses.dataclass
class CorpusRing:
    """Finished walks, resident on the device.

    ``walks[cursor:cursor+b]`` is where the next batch lands (wrapping);
    ``ocn`` counts occurrences of everything ever appended, ``total`` the
    number of appended walks (it may exceed capacity once the ring wraps).
    """

    walks: torch.Tensor      # (capacity, T) int32, -1 padded
    lengths: torch.Tensor    # (capacity,) int32
    ocn: torch.Tensor        # (|V|,) int32
    cursor: int = 0          # next write slot
    total: int = 0           # walks ever appended

    @classmethod
    def create(cls, capacity: int, max_len: int, num_nodes: int,
               device) -> "CorpusRing":
        # int32 occurrence counts are bounded by capacity * max_len.
        if capacity * max_len >= 2**31:
            raise ValueError(
                f"CorpusRing capacity {capacity} x max_len {max_len} can "
                "overflow int32 occurrence counts")
        return cls(
            walks=torch.full((capacity, max_len), -1, dtype=torch.int32, device=device),
            lengths=torch.zeros(capacity, dtype=torch.int32, device=device),
            ocn=torch.zeros(num_nodes, dtype=torch.int32, device=device))

    @property
    def capacity(self) -> int:
        return int(self.walks.shape[0])

    @property
    def num_filled(self) -> int:
        return min(self.total, self.capacity)


def ring_append(ring: CorpusRing, paths: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """Append a batch of walks in place, accumulating ``ocn``."""
    b = paths.shape[0]
    slots = (ring.cursor + torch.arange(b, device=paths.device)) % ring.capacity
    flat = paths.reshape(-1)
    ring.ocn.index_add_(0, flat.clamp_min(0).to(torch.int64),
                        (flat >= 0).to(torch.int32))
    ring.walks[slots] = paths.to(torch.int32)
    ring.lengths[slots] = lengths.to(torch.int32)
    ring.cursor = (ring.cursor + b) % ring.capacity
    ring.total += b


def ring_replace(ring: CorpusRing, slots: torch.Tensor, paths: torch.Tensor,
                 lengths: torch.Tensor) -> None:
    """Overwrite ring slots in place: the incremental refresh's write path.
    A re-walked vertex's new walk takes its stale walk's slot, so every
    other slot stays bit-identical. ``ocn`` stays exact: the replaced slots'
    tokens are subtracted before the new walks' tokens are added.
    ``cursor`` and ``total`` do not move: a replacement is not an append."""
    slots = slots.to(torch.int64)
    old = ring.walks[slots].reshape(-1)
    ring.ocn.index_add_(0, old.clamp_min(0).to(torch.int64), -(old >= 0).to(torch.int32))
    flat = paths.reshape(-1)
    ring.ocn.index_add_(0, flat.clamp_min(0).to(torch.int64), (flat >= 0).to(torch.int32))
    ring.walks[slots] = paths.to(torch.int32)
    ring.lengths[slots] = lengths.to(torch.int32)


def ring_export(ring: CorpusRing) -> Dict[str, np.ndarray]:
    """The whole ring as host arrays, the snapshot surface: the reference's
    ``ring_export`` (int32 walks, lengths and ocn, 0-d int32 cursor and
    total). Importing it gives the ring back bit for bit, cursor and total
    included, so the slot-indexed host maps stay aligned."""
    return {"walks": ring.walks.cpu().numpy(), "lengths": ring.lengths.cpu().numpy(),
            "ocn": ring.ocn.cpu().numpy(), "cursor": np.asarray(ring.cursor, np.int32),
            "total": np.asarray(ring.total, np.int32)}


def ring_import(state: Dict[str, np.ndarray], device) -> CorpusRing:
    """Rebuild a device ring from ``ring_export``'s output, the port's or the
    reference's (walks, lengths, ocn, cursor, total)."""
    as_i32 = lambda a: torch.from_numpy(np.array(a, np.int32)).to(device)
    return CorpusRing(walks=as_i32(state["walks"]),
                      lengths=as_i32(state["lengths"]),
                      ocn=as_i32(state["ocn"]),
                      cursor=int(state["cursor"]), total=int(state["total"]))


def ring_to_numpy(ring: CorpusRing) -> Tuple[np.ndarray, np.ndarray]:
    """The filled slots (oldest -> newest) on the host."""
    n = ring.num_filled
    walks = ring.walks.cpu().numpy()
    lengths = ring.lengths.cpu().numpy()
    if ring.total > ring.capacity:                   # wrapped: rotate
        c = ring.cursor
        order = np.concatenate([np.arange(c, ring.capacity), np.arange(c)])
        walks, lengths = walks[order], lengths[order]
    return walks[:n], lengths[:n].astype(np.int64)


def generate_corpus(
    graph: CSRGraph,
    *,
    policy: Policy,
    spec: WalkSpec,
    delta: float = 1e-3,
    min_rounds: int = 2,
    max_rounds: int = 20,
    window: int = 1,
    seed: int = 0,
    part: Optional[np.ndarray] = None,
) -> Corpus:
    """Rounds of walks from every node until Delta D_r <= delta, as a host
    ``Corpus`` (the reference's sampler). With a partition ``part`` (node ->
    shard) the walks run on the partition-sharded engine, which draws the
    same walks and measures their cross-shard messages."""
    if policy.needs_edge_cm and graph.edge_cm is None:
        graph = graph.with_edge_cm()
    n, dev = graph.num_nodes, graph.device
    sources = torch.arange(n, device=dev)
    degrees = graph.degrees().cpu().numpy()
    controller = WalkCountController(delta=delta, min_rounds=min_rounds,
                                     max_rounds=max_rounds, window=window)
    key = prng.PRNGKey(seed)
    ring = CorpusRing.create(max_rounds * n, spec.max_len, n, dev)
    num_shards = None if part is None else int(np.max(part)) + 1
    agg = {"supersteps": 0, "accepts": 0, "rejects": 0, "msg_count": 0, "msg_bytes": 0.0,
           "msg_bytes_analytic": 0.0}
    by_vertex = spec.rng_mode == "vertex"
    keep_walking = True
    while keep_walking:
        key, round_key = prng.split(key)
        # Lane keys: the reference splits a fresh key off the round key for
        # each of its REF_CHUNK-source chunks in turn, a chain derived on
        # the host once per round. Vertex keys: every chunk walks under the
        # round key itself (the source ids tell the lanes apart).
        chunk_keys = []
        for _ in range(0, 0 if by_vertex else n, REF_CHUNK):
            round_key, k = prng.split(round_key)
            chunk_keys.append(k)
        for start in range(0, n, MAX_LANES):
            chunk = sources[start:start + MAX_LANES]
            keys = (VertexKeys(round_key, chunk) if by_vertex else
                    LaneKeys.of(chunk_keys[start // REF_CHUNK:(start + MAX_LANES) // REF_CHUNK],
                                REF_CHUNK, len(chunk), dev))
            st = run_walk_batch(graph, chunk, keys, policy, spec, part, num_shards=num_shards)
            ring_append(ring, st.path, st.info.L)
            s = batch_stats(st)
            for field in agg:
                agg[field] += s[field]
        keep_walking = controller.update(degrees, ring.ocn.cpu().numpy())
    walks, lengths = ring_to_numpy(ring)
    agg["mean_len"] = float(lengths.mean()) if len(lengths) else 0.0
    agg["d_history"] = list(controller.history)
    return Corpus(walks=walks, lengths=lengths,
                  ocn=ring.ocn.cpu().numpy().astype(np.int64),
                  rounds=controller.rounds, stats=agg)


@dataclasses.dataclass(frozen=True)
class FrequencyOrder:
    """Bijection node id <-> frequency rank (rank 0 = hottest).

    to_rank[v] = rank of node v; to_node[r] = node at rank r.
    """

    to_rank: np.ndarray
    to_node: np.ndarray
    sorted_ocn: np.ndarray   # occurrences in rank order (non-increasing)

    @classmethod
    def from_ocn(cls, ocn: np.ndarray) -> "FrequencyOrder":
        ocn = np.asarray(ocn, dtype=np.int64)
        to_node = np.argsort(-ocn, kind="stable").astype(np.int32)
        to_rank = np.empty_like(to_node)
        to_rank[to_node] = np.arange(len(to_node), dtype=np.int32)
        return cls(to_rank=to_rank, to_node=to_node, sorted_ocn=ocn[to_node])

    def relabel_walks(self, walks: np.ndarray) -> np.ndarray:
        """Map a -1-padded walk array into rank space."""
        out = np.where(walks >= 0, self.to_rank[np.maximum(walks, 0)], -1)
        return out.astype(np.int32)

    def hotness_blocks(self) -> Tuple[np.ndarray, np.ndarray]:
        """Equal-frequency block boundaries (starts, ends) in rank space,
        hottest block first (paper §4.2-III)."""
        occ = self.sorted_ocn
        if len(occ) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        change = np.nonzero(np.diff(occ))[0] + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(occ)]])
        return starts.astype(np.int64), ends.astype(np.int64)
