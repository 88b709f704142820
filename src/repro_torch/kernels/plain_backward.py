"""A hand-written kernel's forward pass with its plain version's backward.

The reference has no backward kernel: it trains on its plain versions. On
the card the port runs a kernel's forward pass (``launch``) inside
``PlainBackward``, whose backward recomputes the plain version (``plain``)
under autograd from the saved inputs and returns its vector-Jacobian
product for whichever outputs received a gradient, so the gradients are
exactly the plain version's. The backward runs in a profiler range named
by the caller, so that a trace shows it apart from the kernels.

An input passed twice (MLA passes its latent as k and as v) reaches
``launch`` as one object, so the kernel keeps its one-tile load; the
backward returns one gradient for each use and autograd adds the two into
the input, as it adds the two uses' gradients in the plain version's own
graph: one addition, so the same bits.

The K2 and K3 wrappers (``flash_attention/ops.py``, ``ssm_scan/ops.py``)
call it for CUDA tensors.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.profiler


class PlainBackward(torch.autograd.Function):
    """``apply(launch, plain, label, *inputs)``: ``launch(*inputs)`` forward,
    the VJP of ``plain(*inputs)`` backward, in the profiler range ``label``.
    Both return a tensor or a tuple of tensors, the same for both."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, label: str, *inputs):
        ctx.plain, ctx.label = plain, label
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grad_outs):
        with torch.enable_grad(), torch.profiler.record_function(ctx.label):
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = ctx.plain(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grad_outs) if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs])
        return (None, None, None, *grads)
