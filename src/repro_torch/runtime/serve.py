"""Slot-pool wave batching, copied from the JAX package's
``runtime/serve.py`` (``wave_batches``). The embedding server of that
module (``EmbedServer``) is not ported yet (ROADMAP.md item 11)."""

from __future__ import annotations

from typing import Iterator, Sequence


def wave_batches(items: Sequence, slots: int) -> Iterator[list]:
    """Yield consecutive waves of at most ``slots`` items: the refill
    order of a fixed slot pool fed from a queue (continuous batching)."""
    slots = max(int(slots), 1)
    for i in range(0, len(items), slots):
        yield list(items[i:i + slots])
