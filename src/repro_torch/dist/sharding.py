"""The partition-spec vocabulary and its resolution against a mesh: the
port of the JAX package's ``dist/sharding.py``.

The repo writes *production* specs everywhere (batch dims over ``("pod",
"data")``, tensor dims over ``"model"``) and resolves them against
whatever mesh is present. Resolution drops axes the mesh lacks (a one-pod
mesh has no "pod") and axes whose size does not divide the dimension they
shard, so one spec tree serves every mesh from one process to the
512-rank multi-pod layout.

``P`` is the port's spec type, standing for ``jax.sharding.PartitionSpec``:
one entry per tensor dim, each None, an axis name or a tuple of names. A
resolved spec becomes ``DTensor`` placements on a ``DeviceMesh``
(``placements``): mesh dim i is ``Shard(d)`` when tensor dim d's entry
names it and it has more than one rank, else ``Replicate()`` (a shard over
one rank is the whole tensor, and DTensor's sharding propagation refuses
some views of a dim sharded even over one rank); a dim over several axes
is split by them in mesh order, as JAX splits it. Spec trees are nested dicts and lists
whose leaves are ``P``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple, Union

# Production tensor-parallel degree: the "model" axis of the pod mesh.
PRODUCTION_MODEL_AXIS = 16

# Every batch-parallel dim composes the pod and data axes.
BATCH_AXES = ("pod", "data")

AxisEntry = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: ``P(("pod", "data"), "model")``. A tuple of its
    entries, so specs compare as the reference's do; a leaf, never a
    container, to the tree functions here."""

    def __new__(cls, *entries: AxisEntry):
        return super().__new__(cls, entries)

    def __getnewargs__(self):             # pickles as P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def tree_map_specs(fn: Callable, specs: Any, *rest: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree (dicts, lists and tuples that
    are not ``P``), ``rest`` trees of the same structure."""
    if isinstance(specs, P):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(tree_map_specs(fn, v, *(r[i] for r in rest))
                           for i, v in enumerate(specs))
    raise TypeError(f"not a spec tree leaf: {specs!r}")


def batch_spec(*rest: AxisEntry) -> P:
    """P((pod, data), *rest): the canonical batch-leading spec."""
    return P(BATCH_AXES, *rest)


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, axis: AxisEntry) -> int:
    """Ranks behind an axis entry (None -> 1, tuples multiply); an axis the
    mesh lacks counts as 1, as ``resolve_spec`` drops it."""
    if axis is None:
        return 1
    if isinstance(axis, str):
        return int(_axis_sizes(mesh).get(axis, 1))
    return math.prod(mesh_axis_size(mesh, a) for a in axis)


def _entry_names(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def resolve_spec(spec: P, mesh, shape: Optional[Sequence[int]] = None) -> P:
    """Resolve a production spec against a concrete mesh: per dim keep the
    axis names the mesh has; if ``shape`` is given and their total size
    does not divide that dim, replicate it. A one-name tuple collapses to
    the bare name (P("data"), not P(("data",)))."""
    sizes = _axis_sizes(mesh)
    entries = []
    for i, entry in enumerate(tuple(spec)):
        names = [a for a in _entry_names(entry) if a in sizes]
        if names and shape is not None and int(shape[i]) % math.prod(
                sizes[a] for a in names) != 0:
            names = []
        entries.append(None if not names else names[0] if len(names) == 1 else tuple(names))
    return P(*entries)


def resolve_specs(tree: Any, mesh) -> Any:
    """``resolve_spec`` over a spec tree."""
    return tree_map_specs(lambda s: resolve_spec(s, mesh), tree)


def placements(spec: P, mesh, shape: Optional[Sequence[int]] = None) -> tuple:
    """The ``DTensor`` placements, one per mesh dim, of ``spec`` resolved
    against ``mesh`` (and ``shape``)."""
    from torch.distributed.tensor import Replicate, Shard

    resolved = resolve_spec(spec, mesh, shape)
    sizes = _axis_sizes(mesh)
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(resolved) if name in _entry_names(entry)]
        out.append(Shard(dims[0]) if dims and sizes[name] > 1 else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh and its placements: the port's
    ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: P
    placements: tuple


def named_sharding(mesh, spec: P, shape: Optional[Sequence[int]] = None) -> NamedSharding:
    resolved = resolve_spec(spec, mesh, shape)
    return NamedSharding(mesh, resolved, placements(resolved, mesh))


def _leaf_shape(leaf: Any) -> Tuple[int, ...]:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        import numpy as np
        shape = np.shape(leaf)
    return tuple(int(s) for s in shape)


def _leaves_like(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _leaves_like(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_leaves_like(fn, v) for v in tree)
    return fn(tree)


def sharding_tree(specs: Any, mesh, shapes: Any) -> Any:
    """Resolve a spec tree against a tree of tensors (or of anything with a
    ``shape``) -> a ``NamedSharding`` tree. ``specs`` may be one ``P``,
    broadcast over every leaf of ``shapes``."""
    if isinstance(specs, P):
        return _leaves_like(lambda leaf: named_sharding(mesh, specs, _leaf_shape(leaf)), shapes)
    return tree_map_specs(lambda s, leaf: named_sharding(mesh, s, _leaf_shape(leaf)),
                          specs, shapes)
