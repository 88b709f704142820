"""Hold the kernels' autograd wrappers to their plain versions.

K2 (``flash_attention``, through ``ops.attend``, the models' entry) and
K3 (``ssd_scan_heads``, ``ssd_chunked_scan``) run their forward pass on
the card through a hand-written kernel and their backward pass through
the plain version's vector-Jacobian product. These
helpers run one forward and one ``backward()`` with a given upstream
gradient through the wrapper, and the same through the plain version
(``ref.mha_reference``; ``ssd_chunked_ref``, in the heads form on B and C
expanded to every head), on the same inputs, so that a caller can hold
the forward to the kernel's tolerance and every input gradient bit for bit.
``chip_smoke.py`` and the card tests call them.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.kernels.ssm_scan import ref as ssd_ref
from repro_torch.kernels.ssm_scan import wide


class GradCase(NamedTuple):
    outputs: List[torch.Tensor]        # the wrapper's forward outputs
    plain_outputs: List[torch.Tensor]  # the plain version's
    grads: List[torch.Tensor]          # the wrapper's input gradients
    plain_grads: List[torch.Tensor]    # the plain version's
    launches: int                      # kernel launches (scans for K3) in the wrapper's run

    def forward_err(self) -> float:
        return max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(self.outputs, self.plain_outputs))

    def grads_equal(self) -> bool:
        return all(torch.equal(a, b) for a, b in zip(self.grads, self.plain_grads))


def _run(fn: Callable, inputs, grad_outs, tie: Optional[tuple] = None):
    """fn on fresh leaves of ``inputs`` (``tie`` (i, j): leaf j is leaf i),
    then backward() with ``grad_outs`` on the outputs that have one."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    args = list(leaves)
    if tie is not None:
        args[tie[1]] = leaves[tie[0]]
    outs = fn(*args)
    outs = list(outs) if isinstance(outs, tuple) else [outs]
    pairs = [(o, g) for o, g in zip(outs, grad_outs) if g is not None]
    torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    own = [t for i, t in enumerate(leaves) if tie is None or i != tie[1]]
    return [o.detach() for o in outs], [t.grad for t in own]


def flash_case(q, k, v, grad_out, *, causal: bool = True,
               sm_scale: Optional[float] = None) -> GradCase:
    """K2's wrapper against ``mha_reference``. With ``v is k`` (MLA's call)
    both runs use one leaf for k and v, whose gradient sums both uses."""
    tie = (1, 2) if v is k else None
    kw = dict(causal=causal, sm_scale=sm_scale)
    before = fa_ops.LAUNCHES
    outs, grads = _run(lambda q_, k_, v_: fa_ops.attend(q_, k_, v_, **kw),
                       (q, k, v), (grad_out,), tie)
    launches = fa_ops.LAUNCHES - before
    plain, plain_grads = _run(lambda q_, k_, v_: fa_ref.mha_reference(q_, k_, v_, **kw),
                              (q, k, v), (grad_out,), tie)
    return GradCase(outs, plain, grads, plain_grads, launches)


def scan_case(xdt, loga, b, c, chunk: int, grad_y, grad_state=None) -> GradCase:
    """K3's wrapper against its plain version: the heads form for 4-D xdt
    (B, H, S, P) with b, c (B, G, S, N), else the reference's 3-D form."""
    heads = xdt.dim() == 4
    fn = ssd_ops.ssd_scan_heads if heads else ssd_ops.ssd_chunked_scan
    plain = ssd_ops._plain if heads else ssd_ref.ssd_chunked_ref
    before = ssd_ops.LAUNCHES + wide.LAUNCHES
    outs, grads = _run(lambda *a: fn(*a, chunk=chunk), (xdt, loga, b, c),
                       (grad_y, grad_state))
    launches = ssd_ops.LAUNCHES + wide.LAUNCHES - before
    plain_outs, plain_grads = _run(lambda *a: plain(*a, chunk=chunk), (xdt, loga, b, c),
                                   (grad_y, grad_state))
    return GradCase(outs, plain_outs, grads, plain_grads, launches)
