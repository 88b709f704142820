"""Atomic, validated checkpoints in the JAX package's on-disk layout.

Layout: ``<root>/step_<N>/`` holding one ``leaf_<i>.npy`` per tree leaf plus
``manifest.json`` (leaf index: path, file, dtype, shape; user metadata).
Leaves are numbered in JAX's flatten order (dict keys sorted, sequences by
index, ``None`` no leaf) and their paths are joined by ``/``
(``graph/indptr``, ``ring/walks``), as the JAX package's ``_path_str``
joins them, so either package reads the other's checkpoints. Writes go to
``step_<N>.tmp`` and are committed by a single atomic ``rename``: a
half-written checkpoint is never visible.

Durability: every leaf file and the manifest are fsynced, then the tmp
directory itself, *before* the rename, and the parent directory after it.
Rename atomicity alone is not enough on a real filesystem: a crash after
the rename can otherwise commit a directory whose data blocks never reached
the disk. Stale ``.tmp`` directories from crashed saves are swept on the
next save.

Reads are defensive: ``latest_step`` / ``load_checkpoint`` treat a step
directory with a corrupt or missing ``manifest.json`` (or a missing leaf
file) as non-existent and fall back to the newest *valid* step — a torn
checkpoint costs one snapshot of progress, not the whole run.

Leaves are saved as whole host arrays; tensors on the card are copied to
the host first. Types numpy cannot save portably (bfloat16) are stored as
their raw bits with the true dtype in the manifest, as the JAX package
stores them. ``reshard_to_mesh`` places a restored host tree onto any
device mesh as ``DTensor`` leaves.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

_PLAIN_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
                 "uint64", "uint32", "uint16", "uint8", "bool")
_BITS = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted, lists and
    tuples by index, ``None`` an empty subtree; paths joined by ``/``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, sub in items:
        out += flatten(sub, f"{prefix}/{name}" if prefix else name)
    return out


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(array to save, true dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    true_dtype = str(arr.dtype)
    if arr.dtype.kind == "V" or true_dtype not in _PLAIN_DTYPES:
        arr = arr.view(_BITS[arr.dtype.itemsize])      # raw bits: exact
    return arr, true_dtype


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sweep_stale_tmp(root: str) -> None:
    """Remove leftover ``step_*.tmp`` dirs from crashed saves."""
    if not os.path.isdir(root):
        return
    for d in os.listdir(root):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def save_checkpoint(root: str, step: int, tree: Any,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write the tree's leaves and the manifest; fsync everything; commit by
    an atomic rename. Returns the step's path."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    _sweep_stale_tmp(root)            # includes our own tmp if it survived
    os.makedirs(tmp, exist_ok=True)
    index = {}
    for i, (path, leaf) in enumerate(flatten(tree)):
        arr, true_dtype = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        index[path] = {"file": fname, "dtype": true_dtype, "shape": list(arr.shape)}
    manifest = {"step": step, "leaves": index, "meta": meta or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)                   # leaf entries durable before the commit
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)             # atomic commit
    _fsync_dir(root)                  # the rename itself durable
    return final


def _read_manifest(root: str, step: int) -> Optional[Dict[str, Any]]:
    """Manifest of ``step``, or None if the checkpoint is torn or corrupt."""
    d = os.path.join(root, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        for info in manifest["leaves"].values():
            if not os.path.exists(os.path.join(d, info["file"])):
                return None
        return manifest
    except (OSError, ValueError, KeyError):
        return None


def _step_candidates(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return sorted(steps, reverse=True)


def latest_step(root: str) -> Optional[int]:
    """Newest step with a VALID manifest (torn checkpoints are skipped)."""
    for step in _step_candidates(root):
        if _read_manifest(root, step) is not None:
            return step
    return None


def valid_steps(root: str) -> List[int]:
    """Every step with a valid manifest, newest first."""
    return [s for s in _step_candidates(root) if _read_manifest(root, s) is not None]


def prune_steps(root: str, keep_last: int) -> int:
    """Bounded retention: delete all but the newest ``keep_last`` VALID
    checkpoints (torn step dirs older than the newest kept one go too; they
    can never be restored from). Never removes the newest valid step.
    Returns the number of step directories removed."""
    keep_last = max(int(keep_last), 1)
    kept = removed = 0
    for step in _step_candidates(root):
        valid = _read_manifest(root, step) is not None
        if valid and kept < keep_last:
            kept += 1
            continue
        if not valid and kept == 0:
            continue      # torn but newest: the reader skips it anyway
        shutil.rmtree(os.path.join(root, f"step_{step:08d}"), ignore_errors=True)
        removed += 1
    if removed:
        _fsync_dir(root)
    return removed


def read_meta(root: str, step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
    """(step, meta) of the newest valid checkpoint (or of ``step``) without
    loading its arrays."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints under {root}")
    manifest = _read_manifest(root, step)
    if manifest is None:
        raise FileNotFoundError(f"checkpoint step {step} under {root} is missing or torn")
    return manifest["step"], manifest["meta"]


def load_checkpoint(root: str, step: Optional[int] = None,
                    only: Optional[Iterable[str]] = None,
                    ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
    """Returns (step, {path: array}, meta).

    With ``step=None`` the newest VALID checkpoint is loaded; a torn one is
    invisible. An explicitly requested step that is torn raises.
    ``only`` restricts loading to leaves whose path equals one of the given
    prefixes or lies under one (``"phi_in"`` matches ``phi_in`` and
    ``phi_in/...``)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    wanted = lambda path: only is None or any(path == p or path.startswith(p + "/")
                                              for p in only)
    arrays = {path: np.load(os.path.join(d, info["file"]))
              for path, info in manifest["leaves"].items() if wanted(path)}
    return manifest["step"], arrays, manifest["meta"]


def _loaded(arrays: Dict[str, np.ndarray], path: str, leaf: torch.Tensor) -> torch.Tensor:
    """The loaded leaf at ``path`` as a host tensor, checked against the
    template's shape; bfloat16 from its raw bits."""
    if path not in arrays:
        raise KeyError(f"checkpoint missing leaf {path}")
    arr = arrays[path]
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"shape mismatch at {path}: ckpt {arr.shape} vs {tuple(leaf.shape)}")
    if leaf.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _map_leaves(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of nested dicts and lists, by the
    paths ``flatten`` gives; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def restore_into(template: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """Fill a structurally matching template tree (nested dicts and lists of
    tensors) with loaded leaves, each on its template's device and dtype."""
    return _map_leaves(lambda path, leaf: _loaded(arrays, path, leaf).to(leaf.device, leaf.dtype),
                       template)


def copy_into(tree: Any, arrays: Dict[str, np.ndarray]) -> None:
    """Copy loaded leaves into a structurally matching tree's own tensors,
    in place (leaves that require grad included): nothing the size of the
    tree is allocated beside it."""
    with torch.no_grad():
        _map_leaves(lambda path, leaf: leaf.copy_(_loaded(arrays, path, leaf)), tree)


def reshard_to_mesh(tree: Any, mesh, specs: Any, device=None) -> Any:
    """Elastic re-shard: place a host tree (numpy arrays or tensors, whole
    on every rank) onto ``mesh`` as ``DTensor`` leaves, each by its spec in
    ``specs`` (a tree of ``dist.sharding.P`` mirroring ``tree``) resolved
    against the mesh and the leaf's shape. A tree read back from another
    mesh (``full_tensor()``) lands on the new one bit for bit. ``device``
    defaults to the mesh's current device."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.collectives import mesh_device
    from repro_torch.dist.sharding import placements, tree_map_specs

    device = mesh_device(mesh) if device is None else device

    def put(spec, leaf):
        t = torch.as_tensor(leaf).to(device)
        return distribute_tensor(t, mesh, placements(spec, mesh, tuple(t.shape)))

    return tree_map_specs(put, specs, tree)
