"""The ambient activation-sharding context: the port of the JAX package's
``dist/context.py``.

Model code deep inside the layers does not thread a mesh through every
call, so the caller opens ``activation_sharding(mesh)`` and the layers
call the ``constrain_*`` helpers where the reference's do. With no
context open each helper returns its argument itself. Under one (the
mesh step of ``launch.steps`` opens it and runs the layers on
``DTensor``s), a ``DTensor`` is redistributed to the placement its
resolved spec gives; a plain tensor is returned as it is.

Two layout rules, as in the reference:

* **Megatron-SP** (``seq_shard=True``): a (B, S, d) activation between
  blocks shards its batch over ("pod", "data") and its sequence over
  "model";
* **scan inputs stay batch-sharded** (``constrain_scan_inputs``): the
  batch dim over the batch axes, everything else replicated, so a
  recurrent scan's step slices stay on one rank.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch.dist.sharding import BATCH_AXES, P, placements, tree_map_specs

_STATE = threading.local()


def current_context() -> Optional[Tuple[Any, bool]]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, seq_shard: bool = True):
    """Open (mesh, seq_shard) for every ``constrain_*`` call below."""
    prev = current_context()
    _STATE.ctx = (mesh, bool(seq_shard))
    try:
        yield mesh
    finally:
        _STATE.ctx = prev


def _constrain(x: torch.Tensor, spec: P) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    ctx = current_context()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx[0], placements(spec, ctx[0], tuple(x.shape)))


def constrain_activations(x: torch.Tensor) -> torch.Tensor:
    """Pin a (B, S, d) inter-block activation: batch over ("pod", "data")
    and, with Megatron-SP on, sequence over "model"."""
    ctx = current_context()
    if ctx is None:
        return x
    entries: list = [BATCH_AXES] + [None] * (x.dim() - 1)
    if ctx[1] and x.dim() >= 3:
        entries[1] = "model"
    return _constrain(x, P(*entries))


def constrain_scan_inputs(x: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
    """Pin a scan input to the batch-sharded layout."""
    if current_context() is None:
        return x
    entries: list = [None] * x.dim()
    entries[batch_dim] = BATCH_AXES
    return _constrain(x, P(*entries))


def constrain_tree(tree: Any, specs: Any) -> Any:
    """``_constrain`` over a tree against its spec tree (gradients against
    the parameter specs)."""
    if current_context() is None:
        return tree
    return tree_map_specs(lambda s, x: _constrain(x, s), specs, tree)
