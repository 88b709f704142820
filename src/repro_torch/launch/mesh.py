"""Device meshes: the port of the JAX package's ``launch/mesh.py`` over
``torch.distributed``'s ``DeviceMesh``.

Single pod: (16, 16) over ("data", "model"), 256 ranks.
Multi-pod:  (2, 16, 16) over ("pod", "data", "model"), 512 ranks.

The "pod" axis composes with "data" for every batch-parallel dim
(``dist.sharding.BATCH_AXES``), so the same specs serve one pod or many.
A mesh needs a default process group of at least its size; every rank of
that group builds it (a rank past its size is not in it). Functions, so
that importing this module touches no process-group state. ``device_type``
defaults to "cuda", which raises where there is no card.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch.device import resolve_device


def _mesh(shape: Tuple[int, ...], axes: Sequence[str], device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device_type).type
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small ("data", "model") mesh over the first data * model ranks:
    the multi-process tests' mesh."""
    return _mesh((data, model), ("data", "model"), device_type)


def chips(mesh) -> int:
    return int(mesh.size())
