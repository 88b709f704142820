"""Import the JAX package's state into the port.

``from_reference_state`` takes the state of ``repro``'s
``StreamingEmbedPipeline`` (its ``_state_tree()``, with every array
already converted to numpy) and returns the port's tensors on a chosen
device, so that both packages can continue from the same state.

``lm_params_from_reference`` takes a language model's parameters from the
reference's ``init_params`` (as numpy) and returns them in the port's
layout, so that both packages compute with the same weights;
``opt_state_from_reference`` does the same for the reference optimizer's
state ({"m", "v", "count"}), so that both can train on from one state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.corpus import ring_import
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph


def from_reference_state(tree: Dict[str, Any], device="cuda",
                         d_history: Optional[Sequence[float]] = None,
                         walk_shards: Optional[int] = None) -> Dict[str, Any]:
    """Reference state (numpy) -> {"phi_in", "phi_out": (S, N, d) float32,
    "ring": CorpusRing, "key_walk", "key_train": prng keys, "stats": walk
    counters as ints, "assignment": the MPGP assignment as int32 numpy, or
    None, "slot_root", "slot_round": the ring's host slot maps (int64, -1
    where never written) or None, "d_history": the ΔD controller's history
    (``d_history``, read off the reference pipeline's
    ``controller.history``, which its state tree does not hold) or None,
    "walk_shards": the walk dispatch's shard count (``walk_shards``, read
    off the reference pipeline, where an elastic reconfiguration or re-join
    moved it from the replica count; the tree holds the assignment only) or
    None, "graph": CSRGraph (when the tree holds one)}. A port pipeline that
    adopts it (``adopt_state``) can continue and refresh from it."""
    dev = resolve_device(device)
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    i64 = lambda name: None if tree.get(name) is None else np.array(tree[name], np.int64)
    state = {
        "phi_in": f32(tree["phi_in"]),
        "phi_out": f32(tree["phi_out"]),
        "ring": ring_import(tree["ring"], dev),
        "key_walk": prng.key_of(tree["key_walk"]),
        "key_train": prng.key_of(tree["key_train"]),
        "stats": {k: int(np.asarray(v)) for k, v in tree.get("stats", {}).items()},
        "assignment": (None if tree.get("assignment") is None
                       else np.array(tree["assignment"], np.int32)),
        "slot_root": i64("slot_root"),
        "slot_round": i64("slot_round"),
        "d_history": None if d_history is None else [float(d) for d in d_history],
        "walk_shards": None if walk_shards is None else int(walk_shards),
    }
    if tree.get("graph") is not None:
        state["graph"] = graph_from_arrays(tree["graph"], dev)
    return state


def graph_from_arrays(g: Dict[str, Any], device) -> CSRGraph:
    """A graph stored as arrays (``indptr``, ``indices``, optionally
    ``weights`` and ``edge_cm``; the reference's or a snapshot's dtypes) as a
    ``CSRGraph`` on ``device`` in the port's dtypes."""
    copy = lambda name, dtype: (None if g.get(name) is None else
                                torch.from_numpy(np.array(g[name], dtype)).to(device))
    return CSRGraph(indptr=copy("indptr", np.int64), indices=copy("indices", np.int64),
                    weights=copy("weights", np.float32), edge_cm=copy("edge_cm", np.int32))


def _map(tree, fn):
    """``fn`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tensor(leaf, dev) -> torch.Tensor:
    a = np.array(leaf)
    if a.dtype.name == "bfloat16":      # numpy's bfloat16 extension type: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(a).to(dev)


def lm_params_from_reference(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Reference LM parameters (numpy leaves) -> the port's tree.

    Every ``group_<i>`` of a decoder-only reference, and the ``enc`` and
    ``dec`` stacks of an encoder-decoder one, stack their repetitions on a
    leading axis (``wq`` (L, d, H, hd), ``ln1.scale`` (L, d), ...); the port
    keeps a list with one dict per repetition. Other entries (``embed``,
    ``enc_norm``, ``final_norm``, ``frontend``) carry over as they are.
    Dtypes are kept."""
    dev = resolve_device(device)
    out = {}
    for name, sub in tree.items():
        if name.startswith("group_") or name in ("enc", "dec"):
            lengths = set()
            _map(sub, lambda a: lengths.add(len(a)))
            (n_rep,) = lengths             # every leaf stacks the same repetitions
            out[name] = [_map(sub, lambda a, r=r: _tensor(a[r], dev)) for r in range(n_rep)]
        else:
            out[name] = _map(sub, lambda a: _tensor(a, dev))
    return out


def opt_state_from_reference(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference optimizer's state (numpy leaves: moment trees in the
    parameters' stacked layout, "v" only for AdamW, a scalar int32 "count")
    -> the port's: each moment tree in the port's parameter layout, dtypes
    kept, and "count" a 0-d int32 tensor."""
    dev = resolve_device(device)
    out = {name: lm_params_from_reference(tree[name], dev) for name in ("m", "v") if name in tree}
    out["count"] = torch.tensor(int(np.asarray(tree["count"])), dtype=torch.int32, device=dev)
    return out
