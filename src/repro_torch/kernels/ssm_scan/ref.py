"""Plain PyTorch versions of the Mamba2/SSD selective state-space scan,
ported from the JAX package's ``kernels/ssm_scan/ref.py``.

Per head with state S in R^{N x P} (N = d_state, P = head_dim), scalar
decay a_t = exp(loga_t) (Mamba2's scalar-identity A):

    S_t = a_t * S_{t-1} + B_t ⊗ xdt_t          (B_t in R^N, xdt_t in R^P)
    y_t = C_t^T S_t                             (C_t in R^N)

``xdt`` is x with the Delta step already folded in (x * dt); ``loga`` is
dt * A (negative). ``ssd_scan_reference`` is the sequential oracle,
``ssd_chunked_ref`` the chunked matrix form the CUDA kernel computes, and
``ssd_decode_step`` one recurrent token step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_reference(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, s0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt (BH, S, P), loga (BH, S), b and c (BH, S, N), s0 (BH, N, P) ->
    (y (BH, S, P) in xdt's dtype, final state (BH, N, P) float32), one
    step at a time."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    state = (torch.zeros(bh, n, p, dtype=torch.float32, device=xdt.device)
             if s0 is None else s0.float())
    x, la, bf, cf = xdt.float(), loga.float(), b.float(), c.float()
    ys = []
    for t in range(s):
        state = torch.exp(la[:, t])[:, None, None] * state \
            + bf[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.einsum("zn,znp->zp", cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(bh, 0, p)
    return y.to(xdt.dtype), state


def ssd_chunked_ref(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int = 128, s0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: the same matrix decomposition as the kernel, one chunk
    of q = min(chunk, S) steps at a time. S is padded to a multiple of q
    with loga = 0 and xdt = b = c = 0, which leaves the state as it is;
    y is cut back to S. The masked decay takes 0 above the diagonal by
    selection, never by multiplying an overflowed exp."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    q = min(chunk, s)
    rem = (-s) % q
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, rem))
    xdt_p, b_p, c_p = pad(xdt), pad(b), pad(c)
    loga_p = torch.nn.functional.pad(loga.float(), (0, rem))
    nc = xdt_p.shape[1] // q
    state = (torch.zeros(bh, n, p, dtype=torch.float32, device=xdt.device)
             if s0 is None else s0.float())
    li = torch.arange(q, device=xdt.device)[:, None]
    lj = torch.arange(q, device=xdt.device)[None, :]
    ys = []
    for k in range(nc):
        sl = slice(k * q, (k + 1) * q)
        x_i, la_i, b_i, c_i = xdt_p[:, sl], loga_p[:, sl], b_p[:, sl], c_p[:, sl]
        cum = torch.cumsum(la_i, dim=-1)                       # (BH, Q)
        total = cum[:, -1]
        scores = torch.einsum("zqn,zkn->zqk", c_i, b_i)
        decay = torch.exp(cum[:, :, None] - cum[:, None, :])
        l_mask = torch.where(li >= lj, decay, torch.zeros((), device=xdt.device))
        y = torch.einsum("zqk,zkp->zqp", scores * l_mask, x_i)
        y = y + torch.einsum("zqn,znp->zqp", c_i * torch.exp(cum)[..., None], state)
        b_scaled = b_i * torch.exp(total[:, None, None] - cum[..., None])
        state = torch.exp(total)[:, None, None] * state \
            + torch.einsum("zqn,zqp->znp", b_scaled, x_i)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] if ys else xdt.new_zeros(bh, 0, p, dtype=torch.float32)
    return y.to(xdt.dtype), state


def ssd_decode_step(state: torch.Tensor, xdt: torch.Tensor, loga: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent token step (decode, O(1) per token): state (BH, N, P),
    xdt (BH, P), loga (BH,), b and c (BH, N) -> (y (BH, P), new state)."""
    state = torch.exp(loga)[:, None, None] * state + torch.einsum("bn,bp->bnp", b, xdt)
    y = torch.einsum("bn,bnp->bp", c, state)
    return y, state
