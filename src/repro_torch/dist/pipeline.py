"""GPipe-style pipeline parallelism over one mesh axis: the port of the
JAX package's ``dist/pipeline.py``.

Stage s of an S-stage pipeline lives on rank s of the ``axis`` ring. The
input batch is split into M microbatches; the (S + M - 1)-tick schedule
keeps every rank busy once the pipeline fills, and each tick a ring shift
hands every stage's output to stage s + 1. The shift is a send / receive
pair inside an autograd function whose backward shifts the gradients the
other way round the ring (the reference's ``ppermute`` transposes to the
inverse permutation), so gradients flow back through the stages as in the
sequential program. Forward matches the sequential composition of the
stages, and so do the stage parameters' gradients.

Under gloo a CUDA tensor travels through the host (``collectives``'s
staging, counted in ``PG_STATS``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import _unwire, _wire


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """(M * mb, ...) -> (M, mb, ...) microbatch stream."""
    m = num_microbatches
    if x.shape[0] % m != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible into {m} microbatches")
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to rank (r + step) of the group's ring and return what
    rank (r - step) sent."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    w = _wire(x, group)
    out = torch.empty_like(w)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, w, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return _unwire(out, x)


class _RingShift(torch.autograd.Function):
    """stage s -> s + 1 forward; the gradient s + 1 -> s backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1), None


class _PSum(torch.autograd.Function):
    """The sum over the group, replicated on every rank. Its gradient is
    the output's own (the reference's ``psum`` under a replicated
    ``out_specs``: the loss of the replicated result counts once)."""

    @staticmethod
    def forward(ctx, x, group):
        w = _wire(x, group)
        dist.all_reduce(w, group=group)
        return _unwire(w, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   xs: torch.Tensor, mesh, axis: str = "pipe") -> torch.Tensor:
    """Run ``xs`` (M, mb, ...) through S pipelined stages; returns the (M,
    mb, ...) outputs on every rank of the axis. ``stage_params`` is this
    rank's stage: a tree whose leaves are either (S, ...) (the stage's row
    is taken) or ``DTensor``s sharded on dim 0 over ``axis`` (the local
    row)."""
    group = mesh.get_group(axis)
    num_stages = dist.get_world_size(group)
    stage_id = dist.get_rank(group)
    num_micro = int(xs.shape[0])

    def mine(a):
        if hasattr(a, "to_local"):
            return a.to_local()[0]
        return a[stage_id]

    w = _tree(mine, stage_params)
    # Selections by tensor, not by branch: every rank's graph then holds
    # every tick's shift, so all ranks run the shifts' backward in one order.
    first = torch.tensor(stage_id == 0, device=xs.device)
    last = torch.tensor(stage_id == num_stages - 1, device=xs.device)
    state = torch.zeros_like(xs[0])
    outs = []
    for tick in range(num_stages + num_micro - 1):
        feed = xs[tick] if tick < num_micro else torch.zeros_like(xs[0])
        out = stage_fn(w, torch.where(first, feed, state))
        if tick >= num_stages - 1:
            outs.append(torch.where(last, out, torch.zeros_like(out)))
        state = _RingShift.apply(out, group)
    # Only the last stage wrote non-zeros; the sum replicates its stream.
    return _PSum.apply(torch.stack(outs), group)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)
