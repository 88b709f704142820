"""Training-batch indices over the device corpus ring."""

from __future__ import annotations

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
