"""Step builders and their placement trees: the port of the JAX package's
``launch/steps.py``.

``train_step``  : params, opt_state, batch, step -> params', opt_state', metrics
``prefill_step``: params, batch -> (last-token logits, caches)
``serve_step``  : params, caches, token, cache_len -> (logits, caches')

Gradient accumulation (``cfg.grad_accum`` > 1) runs the batch as that many
microbatches: each microbatch's gradients are cast to
``cfg.grad_accum_dtype`` before they are summed, the sum is divided by the
count and the loss is the microbatches' mean, as in the reference.

On a mesh (``build_train_step(..., mesh=)``) the parameters and the
optimizer state are ``DTensor`` trees placed by their specs
(``train_shardings``, ``ckpt.reshard_to_mesh``), and the layers run on
``DTensor``s under ``dist.context.activation_sharding(mesh,
cfg.act_seq_shard)``: the batch's rows shard over the batch axes ("pod",
"data"), each parameter is gathered whole for its use (``Replicate`` on
every mesh dim, as FSDP gathers a layer's weights), the ``constrain_*``
calls pin the activations between blocks (Megatron-SP shards their
sequence over "model"), and K2's wrapper runs on the local shards of q, k
and v (``kernels.flash_attention.ops``). Autograd through the gathers
returns each gradient placed as its parameter, summed over the batch's
shards. Microbatches split each rank's rows, so every microbatch keeps the
batch's placement. The optimizer then updates each rank's local shards of
the parameters and moments, given the whole gradient's norm: every
operation of the update is elementwise, so the shards end as the
single-process step's would. The matmuls run on whole weights (data
parallel); the reference's partitioner also splits them over "model".
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor

from repro_torch.dist.context import activation_sharding, constrain_tree
from repro_torch.dist.sharding import P, batch_spec, placements, sharding_tree
from repro_torch.models import zoo
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim.optimizers import (AdamWConfig, init_opt_state, leaves, opt_specs,
                                          opt_update, tree_map)
from repro_torch.optim.schedules import cosine_warmup


def default_opt(cfg: ModelConfig) -> AdamWConfig:
    return AdamWConfig(moment_dtype=cfg.opt_state_dtype)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def _loss_and_grads(loss_of, cfg: ModelConfig, params: Any, batch: Dict[str, torch.Tensor],
                    pspecs: Any = None):
    """(loss, gradients in ``leaves`` order) of one batch, run as
    ``cfg.grad_accum`` microbatches; ``pspecs`` (on a mesh) pins each
    microbatch's gradients and their sum to the parameters' layout, as the
    reference does."""
    flat = leaves(params)
    accum = max(cfg.grad_accum, 1)
    with torch.enable_grad():
        for p in flat:
            p.requires_grad_(True)
        if accum == 1:
            loss = loss_of(params, batch)
            return loss.detach(), list(torch.autograd.grad(loss, flat))
        adt = dtype_of(cfg.grad_accum_dtype)
        rows = _local(next(iter(batch.values()))).shape[0]
        if rows % accum:
            raise ValueError(f"batch of {rows} rows does not split into {accum} microbatches")
        mb = rows // accum
        pin = (lambda g: g) if pspecs is None else \
            (lambda g: leaves(constrain_tree(_as_tree(params, g), pspecs)))
        gacc, losses = None, []
        for i in range(accum):
            loss = loss_of(params, {k: _rows(v, i * mb, mb) for k, v in batch.items()})
            g = pin([gg.to(adt) for gg in torch.autograd.grad(loss, flat)])
            gacc = g if gacc is None else pin([a + gg for a, gg in zip(gacc, g)])
            losses.append(loss.detach())
    return sum(losses) / accum, [a / accum for a in gacc]


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _rows(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Rows [start, start + n) of a batch leaf; of each rank's shard for a
    ``DTensor``, placed as the leaf."""
    if not isinstance(x, DTensor):
        return x[start:start + n]
    return DTensor.from_local(x.to_local()[start:start + n], x.device_mesh, x.placements,
                              run_check=False)


def _as_tree(params: Any, flat: List[torch.Tensor]) -> Any:
    """``flat`` (in ``leaves`` order) in the structure of ``params``."""
    by_leaf = {id(p): g for p, g in zip(leaves(params), flat)}
    return tree_map(lambda p: by_leaf[id(p)], params)


def build_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                     total_steps: int = 10_000, lr: float = 3e-4, mesh=None):
    """The training step (the module's docstring); ``mesh`` a
    ``DeviceMesh`` whose axes the specs name, or None for one process.
    ``metrics`` holds the loss and the gradient's global norm (before the
    clip), 0-d float32 tensors."""
    opt_cfg = opt_cfg or default_opt(cfg)
    schedule = cosine_warmup(lr, min(2000, total_steps // 10 + 1), total_steps)
    loss_of = zoo.loss_fn(cfg)

    def train_step(params, opt_state, batch, step):
        loss, grads = _loss_and_grads(loss_of, cfg, params, batch)
        params, opt_state, gnorm = opt_update(grads, opt_state, params, opt_cfg, schedule(step))
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    def gathered_loss(params, batch):
        whole = [Replicate()] * mesh.ndim
        return loss_of(tree_map(lambda p: p.redistribute(mesh, whole), params), batch)

    def mesh_step(params, opt_state, batch, step):
        from torch.distributed.tensor.experimental import implicit_replication

        batch = {k: _batch_dtensor(v, mesh) for k, v in batch.items()}
        # implicit_replication: a plain tensor a layer makes (rotary
        # tables, masks) enters as replicated
        with implicit_replication(), activation_sharding(mesh, cfg.act_seq_shard):
            loss, grads = _loss_and_grads(gathered_loss, cfg, params, batch,
                                          zoo.param_specs(cfg))
        gnorm = _global_norm(grads, mesh)
        opt_update([g.to_local() for g in grads], tree_map(_local, opt_state),
                   tree_map(_local, params), opt_cfg, schedule(step), gnorm=gnorm)
        return params, opt_state, {"loss": loss.full_tensor(), "gnorm": gnorm}

    return train_step if mesh is None else mesh_step


def _batch_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """A batch leaf as a ``DTensor`` whose rows shard over the mesh's batch
    axes: as it is when it is one, else placed from the whole tensor."""
    if isinstance(x, DTensor):
        return x
    spec = batch_spec(*([None] * (x.dim() - 1)))
    return distribute_tensor(x, mesh, placements(spec, mesh, tuple(x.shape)))


def _global_norm(grads: List[DTensor], mesh) -> torch.Tensor:
    """The whole gradient's global norm from the local shards: each leaf's
    float32 sum of squares, divided by the number of ranks that hold the
    same shard (its ``Replicate`` mesh dims), summed over the mesh."""
    local = torch.zeros((), dtype=torch.float32, device=grads[0].to_local().device)
    for g in grads:
        copies = math.prod(mesh.size(d) for d, pl in enumerate(g.placements)
                           if isinstance(pl, Replicate))
        local = local + torch.sum(torch.square(g.to_local().float())) / copies
    total = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim, run_check=False)
    return torch.sqrt(total.full_tensor())


def build_prefill_step(cfg: ModelConfig, max_len: int):
    return zoo.prefill_fn(cfg, max_len)


def build_serve_step(cfg: ModelConfig):
    return zoo.decode_fn(cfg)


# ---------------------------------------------------------------------------
# Placement trees (resolved against a mesh)
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig):
    """The parameter tree's shapes and dtypes, as fake tensors (the
    reference's ``jax.eval_shape`` of ``init_params``): nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return zoo.init_params(cfg, 0, "cpu")


def _replicated(mesh):
    return sharding_tree(P(), mesh, torch.zeros(()))


def train_shardings(cfg: ModelConfig, mesh, specs_in: Dict[str, Any],
                    opt_cfg: Optional[AdamWConfig] = None):
    """(in shardings, out shardings, (param shapes, opt-state shapes)) of
    the training step: ``NamedSharding`` trees (spec and ``DTensor``
    placements), ``specs_in["batch"]`` the batch tree (or its shapes)."""
    opt_cfg = opt_cfg or default_opt(cfg)
    pspecs = zoo.param_specs(cfg)
    pshapes = param_shapes(cfg)
    params_sh = sharding_tree(pspecs, mesh, pshapes)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        oshapes = init_opt_state(pshapes, opt_cfg)
    opt_sh = sharding_tree(opt_specs(pspecs, opt_cfg), mesh, oshapes)
    batch_sh = sharding_tree(zoo.train_batch_specs(cfg), mesh, specs_in["batch"])
    metrics_sh = {"loss": _replicated(mesh), "gnorm": _replicated(mesh)}
    in_sh = (params_sh, opt_sh, batch_sh, _replicated(mesh))
    out_sh = (params_sh, opt_sh, metrics_sh)
    return in_sh, out_sh, (pshapes, oshapes)


def _output_shapes(fn, *args):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return fn(*args)


def prefill_shardings(cfg: ModelConfig, mesh, specs_in: Dict[str, Any], prefill_fn=None,
                      max_len: int = 0):
    """(in, out, param shapes) of the prefill step; the outputs' shapes come
    from running it on fake tensors."""
    pspecs = zoo.param_specs(cfg)
    pshapes = param_shapes(cfg)
    params_sh = sharding_tree(pspecs, mesh, pshapes)
    bspecs = {k: v for k, v in zoo.train_batch_specs(cfg).items() if k in specs_in["batch"]}
    batch_sh = sharding_tree(bspecs, mesh, specs_in["batch"])
    fn = prefill_fn or build_prefill_step(cfg, max_len)
    logits, caches = _output_shapes(fn, pshapes, specs_in["batch"])
    out_sh = (sharding_tree(batch_spec("model"), mesh, logits),
              sharding_tree(zoo.cache_specs(cfg), mesh, caches))
    return (params_sh, batch_sh), out_sh, pshapes


def serve_shardings(cfg: ModelConfig, mesh, specs_in: Dict[str, Any], serve_fn=None):
    """(in, out, param shapes) of the decode step."""
    pspecs = zoo.param_specs(cfg)
    pshapes = param_shapes(cfg)
    params_sh = sharding_tree(pspecs, mesh, pshapes)
    caches_sh = sharding_tree(zoo.cache_specs(cfg), mesh, specs_in["caches"])
    token_sh = sharding_tree(batch_spec(None), mesh, specs_in["token"])
    fn = serve_fn or build_serve_step(cfg)
    logits, _ = _output_shapes(fn, pshapes, specs_in["caches"], specs_in["token"],
                               specs_in["cache_len"])
    logits_sh = sharding_tree(batch_spec("model"), mesh, logits)
    return (params_sh, caches_sh, token_sh, _replicated(mesh)), (logits_sh, caches_sh), pshapes
