"""Rank-side bodies of the port's multi-process tests.

``repro_torch.dist.spawn.run_ranks`` starts each rank in a fresh process
that imports this module (not a test module: those import JAX, and the
ranks must not). Every function takes (rank, k, inputs) and returns plain
numpy values that the parent compares with the stacked runs and with the
reference, which only the parent computes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import shard_engine
from repro_torch.core.shard_engine import make_walk_mesh, run_walk_sharded
from repro_torch.core.transition import make_policy
from repro_torch.core.walker import LaneKeys, WalkSpec
from repro_torch.graph.csr import CSRGraph

STATE_FIELDS = ("cur", "prev", "path", "h_series", "hring", "active", "accepts", "rejects",
                "msg_count", "msg_bytes", "msg_bytes_analytic")
INFO = ("H", "L", "EH", "EL", "EHL", "EH2", "EL2")


def state_arrays(st) -> dict:
    """A walk state as numpy, every field the tests hold bit for bit."""
    out = {f: getattr(st, f).cpu().numpy() for f in STATE_FIELDS}
    out.update({f"info.{f}": getattr(st.info, f).cpu().numpy() for f in INFO})
    out["supersteps"] = int(st.supersteps)
    return out


def walk_case(graphs: dict, inputs: dict, case: dict, mesh):
    """One ``run_walk_sharded`` call of a case (stacked when ``mesh`` is
    None): (state arrays, stats)."""
    graph = graphs[case["graph"]]
    lanes = inputs["lanes"]
    keys = LaneKeys.of([prng.PRNGKey(case["seed"])], lanes, lanes, graph.device)
    kw = {n: case[n] for n in ("engine", "transport", "exchange_cap", "pool_factor",
                               "compact_every") if case.get(n) is not None}
    st, stats = run_walk_sharded(graph, torch.arange(lanes) % graph.num_nodes, keys,
                                 make_policy(case["policy"]), WalkSpec(**case["spec"]),
                                 inputs["parts"][case["k"]], case["k"], mesh,
                                 with_stats=True, **kw)
    return state_arrays(st), stats


def graphs_of(inputs: dict, device="cpu") -> dict:
    """The cases' graphs from their numpy arrays."""
    t = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return {name: CSRGraph(indptr=t(g["indptr"]), indices=t(g["indices"]),
                           weights=t(g.get("weights")), edge_cm=t(g.get("edge_cm")))
            for name, g in inputs["graphs"].items()}


def walk_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every case of ``inputs["cases"]`` on a mesh of its k ranks (ranks
    past k wait); returns {case name: (state arrays, stats)} for the cases
    this rank ran, and the SPMD batch count."""
    graphs = graphs_of(inputs)
    ks = sorted({c["k"] for c in inputs["cases"].values()})
    meshes = {k: make_walk_mesh(k, "cpu") for k in ks}
    out = {}
    for name, case in inputs["cases"].items():
        mesh = meshes[case["k"]]
        if mesh.get_coordinate() is not None:
            out[name] = walk_case(graphs, inputs, case, mesh)
    return {"cases": out, "spmd_batches": shard_engine.SPMD_BATCHES,
            "batches": shard_engine.BATCHES}


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_numpy(v) for v in tree)
    if hasattr(tree, "full_tensor"):
        tree = tree.full_tensor()
    return tree.detach().cpu().numpy()


def _tree_tensor(tree):
    if isinstance(tree, dict):
        return {k: _tree_tensor(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_tensor(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def mesh_cases(rank: int, world: int, inputs: dict) -> dict:
    """The mesh layer's cases on four ranks: spec resolution, the hotness
    sync, the compressed all-reduce, the pipeline, the K2 wrapper and the
    constrain helpers on DTensors, re-sharding, and a (2, 2) data x model
    train step at grad_accum 1 and 2. Rank 0 returns whole results; every
    rank returns what it checked itself."""
    import dataclasses

    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.ckpt.checkpoint import reshard_to_mesh
    from repro_torch.dist import collectives as col
    from repro_torch.dist.context import activation_sharding, constrain_activations
    from repro_torch.dist.pipeline import microbatch, pipeline_apply
    from repro_torch.dist.sharding import P, mesh_axis_size, resolve_spec, resolve_specs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import chips, make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.optim.optimizers import init_opt_state, opt_specs

    out = {}
    # ---- spec resolution on the (1, 1) host mesh (every rank builds it) ----
    m11 = make_host_mesh(1, 1, "cpu")
    if rank == 0:
        out["resolve"] = {
            "drop_missing": resolve_spec(P(("pod", "data"), "model"), m11, (4, 4)),
            "nondivisible": resolve_spec(P("data"), m11, (3,)),
            "tree": resolve_specs({"a": P("pod", "model"), "b": {"c": P(("pod", "data"))}}, m11),
            "sizes": [mesh_axis_size(m11, None), mesh_axis_size(m11, "data"),
                      mesh_axis_size(m11, ("data", "model"))],
            "chips": chips(m11)}
    m22 = make_host_mesh(2, 2, "cpu")
    out["resolve22"] = {
        "nondivisible": resolve_spec(P("data", "model"), m22, (3, 4)),
        "pod_data": resolve_spec(P(("pod", "data"), None), m22, (4, 3)),
        "sizes": [mesh_axis_size(m22, "data"), mesh_axis_size(m22, ("pod", "data", "model"))]}

    # ---- hotness sync and compressed all-reduce over a 4-rank axis --------
    line = col.local_mesh(4, "data", "cpu")
    col.reset_pg_stats()
    pi = torch.from_numpy(inputs["replicas_in"][rank].copy())
    po = torch.from_numpy(inputs["replicas_out"][rank].copy())
    pi2, po2, nbytes = col.hotness_sync_spmd(pi, po, torch.from_numpy(inputs["rows"]), line,
                                             "data")
    out["hotness"] = (pi2.numpy(), po2.numpy(), nbytes, pi2.data_ptr() == pi.data_ptr())
    synced, resid = col.compressed_allreduce(torch.from_numpy(inputs["grad"][rank]),
                                             torch.from_numpy(inputs["error"][rank]), 0.5,
                                             line, "data")
    out["compressed"] = (synced.numpy(), resid.numpy())
    out["pg_stats"] = dict(col.PG_STATS)

    # ---- pipeline: 4 stages on the "pipe" ring ----------------------------
    pipe = col.local_mesh(4, "pipe", "cpu")
    w = torch.from_numpy(inputs["pipe_w"]).requires_grad_(True)
    x = torch.from_numpy(inputs["pipe_x"])
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p), w, microbatch(x, inputs["pipe_m"]), pipe)
    (y ** 2).sum().backward()
    g = w.grad.clone()
    torch.distributed.all_reduce(g)            # each rank holds its own stage's rows
    out["pipeline"] = (y.detach().reshape(x.shape).numpy(), g.numpy())

    # ---- K2's wrapper and the constrain helpers on DTensors ----------------
    q, k, v = (torch.from_numpy(inputs["attn"][n]) for n in "qkv")
    place = (Shard(0), Shard(1))
    dq, dk, dv = (distribute_tensor(t, m22, place) for t in (q, k, v))
    got = fa_ops.attend(dq, dk, dv, causal=True)
    want = fa_ops.attend(q, k, v, causal=True)
    seq = (Shard(0), Shard(2))                # a sequence shard is gathered first
    got_seq = fa_ops.attend(*(distribute_tensor(t, m22, seq) for t in (q, k, v)), causal=True)
    out["attend_dtensor"] = (isinstance(got, DTensor) and got.placements == place,
                             bool(torch.equal(got.full_tensor(), want)),
                             got_seq.placements == (Shard(0), Replicate()),
                             bool(torch.equal(got_seq.full_tensor(), want)))
    act = distribute_tensor(torch.from_numpy(inputs["act"]), m22, (Replicate(), Replicate()))
    same = constrain_activations(act) is act
    with activation_sharding(m22):
        pinned = constrain_activations(act)
    out["constrain"] = (same, tuple(pinned.placements) == (Shard(0), Shard(1)),
                        bool(torch.equal(pinned.full_tensor(), act.full_tensor())))

    # ---- re-sharding a tree from one mesh to another ----------------------
    tree = _tree_tensor(inputs["reshard_tree"])
    specs = {"a": P("data", "model"), "b": [P(None, "model"), P(("pod", "data"))]}
    on22 = reshard_to_mesh(tree, m22, specs)
    m41 = make_host_mesh(4, 1, "cpu")
    on41 = reshard_to_mesh(_tree_numpy(on22), m41, specs)
    out["reshard"] = {"22": [tuple(on22["a"].placements), on22["a"].to_local().numpy()],
                      "41": [tuple(on41["a"].placements), on41["a"].to_local().numpy(),
                             on41["b"][1].to_local().numpy()],
                      "whole": _tree_numpy(on41)}

    # ---- the (2, 2) data x model train step --------------------------------
    base = inputs["train"]["cfg"]
    batch = {n: torch.from_numpy(a) for n, a in inputs["train"]["batch"].items()}
    out["train"] = {}
    for accum in inputs["train"]["accums"]:
        cfg = dataclasses.replace(base, grad_accum=accum)
        opt_cfg = steps.default_opt(cfg)
        pspecs = zoo.param_specs(cfg)
        host = _tree_tensor(inputs["train"]["params"])
        params = reshard_to_mesh(host, m22, pspecs)
        opt = reshard_to_mesh(init_opt_state(host, opt_cfg), m22, opt_specs(pspecs, opt_cfg))
        step = steps.build_train_step(cfg, total_steps=10, mesh=m22)
        params, opt, metrics = step(params, opt, batch, 1)          # lr 0.5 * 3e-4
        whole, moments = _tree_numpy(params), _tree_numpy(opt["m"])   # collectives: every rank
        if rank == 0:
            out["train"][accum] = {"loss": float(metrics["loss"]),
                                   "gnorm": float(metrics["gnorm"]), "params": whole,
                                   "m": moments}
    return out


def staged_case(rank: int, world: int, inputs: dict) -> dict:
    """The collectives on CUDA tensors over a gloo group (ranks sharing a
    card): each result on the card, equal to its stacked form, with the
    bytes staged through the host counted."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as col

    dev = torch.device("cuda", torch.cuda.current_device())
    group = dist.group.WORLD
    col.reset_pg_stats()
    x = torch.arange(world * 6, dtype=torch.int64, device=dev).reshape(world, 2, 3) + 100 * rank
    mask = (torch.arange(6, device=dev).reshape(1, 6) % world) == rank
    summed = col.psum(x[None, 0].float(), group)
    gathered = col.all_gather(mask, group)
    swapped = col.all_to_all(x[None], group)
    flags = col.host_read([torch.tensor(rank, device=dev)], group)
    return {"device": (summed.device.type, gathered.device.type, swapped.device.type),
            "summed": summed.cpu().numpy(), "gathered": gathered.cpu().numpy(),
            "swapped": swapped.cpu().numpy(), "flags": flags, "stats": dict(col.PG_STATS),
            "backend": dist.get_backend(group)}
