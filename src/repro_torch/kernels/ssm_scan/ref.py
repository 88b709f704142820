"""Plain PyTorch versions of the Mamba2/SSD selective state-space scan,
ported from the JAX package's ``kernels/ssm_scan/ref.py``.

Per head with state S in R^{N x P} (N = d_state, P = head_dim), scalar
decay a_t = exp(loga_t) (Mamba2's scalar-identity A):

    S_t = a_t * S_{t-1} + B_t ⊗ xdt_t          (B_t in R^N, xdt_t in R^P)
    y_t = C_t^T S_t                             (C_t in R^N)

``xdt`` is x with the Delta step already folded in (x * dt); ``loga`` is
dt * A (negative). ``ssd_scan_reference`` is the sequential oracle,
``ssd_chunked_ref`` the chunked matrix form the CUDA kernels compute,
``ssd_chunk_state_ref`` and ``ssd_chunk_out_ref`` its two phases as the
first route's two launches split it (C B^T and the chained state after each
chunk; then the output; composed in ``ssd_chunked_phases_ref``; the chained
state is itself each chunk's local state, ``ssd_chunk_local_ref``, chained
elementwise, ``ssd_state_chain_ref``, as the wide route's launches split
it), and ``ssd_decode_step`` one recurrent token step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist.context import constrain_scan_inputs


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
    selection, never by multiplying an overflowed exp: the exponent is
    selected (-inf above the diagonal) before the exp, so that neither the
    decay nor its gradient meets exp(cum_i - cum_j) overflowed to inf. (The
    reference selects after the exp: the same values, but 0 * inf = NaN in
    its gradient wherever the decay overflows above the diagonal, which the
    model's decay does within a chunk of 128 steps.)"""
    # The chunk loop slices along S: the inputs stay batch-sharded under a
    # mesh (``dist.context``), so each chunk is one rank's.
    xdt, loga, b, c = (constrain_scan_inputs(t) for t in (xdt, loga, b, c))
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
        l_mask = torch.exp(torch.where(li >= lj, cum[:, :, None] - cum[:, None, :],
                                       float("-inf")))
        y = torch.einsum("zqk,zkp->zqp", scores * l_mask, x_i)
        y = y + torch.einsum("zqn,znp->zqp", c_i * torch.exp(cum)[..., None], state)
        b_scaled = b_i * torch.exp(total[:, None, None] - cum[..., None])
        state = torch.exp(total)[:, None, None] * state \
            + torch.einsum("zqn,zqp->znp", b_scaled, x_i)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] if ys else xdt.new_zeros(bh, 0, p, dtype=torch.float32)
    return y.to(xdt.dtype), state


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(BH, S, ...) -> (BH, nc, q, ...) float32 with q = min(chunk, S): S
    padded with zeros to a multiple of q, as ``ssd_chunked_ref`` pads it."""
    bh, s = t.shape[:2]
    q = min(chunk, s)
    pad = [0, 0] * (t.dim() - 2) + [0, (-s) % q]
    return torch.nn.functional.pad(t.float(), pad).reshape(bh, -1, q, *t.shape[2:])


def ssd_chunk_local_ref(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                        chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """cum (BH, nc, q) and each chunk's local state (BH, nc, N, P), (B .
    exp(cum_q - cum))^T xdt over that chunk alone: the state the chunk
    leaves from a zero state, for every chunk at once (the wide route's
    cum and state launches)."""
    x, bb = _chunks(xdt, chunk), _chunks(b, chunk)
    cum = torch.cumsum(_chunks(loga, chunk), dim=-1)
    wdec = torch.exp(cum[..., -1:] - cum)
    return cum, torch.einsum("zkqn,zkqp->zknp", bb * wdec[..., None], x)


def ssd_state_chain_ref(cum: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """The state after each chunk (BH, nc, N, P), S_k = exp(cum_q,k) S_{k-1}
    + local_k from S_{-1} = 0: elementwise along the chunks (the wide
    route's chain launch)."""
    state = torch.zeros_like(local[:, 0])
    states = []
    for k in range(local.shape[1]):
        state = torch.exp(cum[:, k, -1])[:, None, None] * state + local[:, k]
        states.append(state)
    return torch.stack(states, dim=1)


def ssd_chunk_state_ref(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, chunk: int = 128):
    """Launch 1: cum (BH, nc, q), C B^T (BH, nc, q, q) (the kernel keeps its
    blocks on and below the diagonal, once per group) and the state after
    each chunk (BH, nc, N, P), S_k = exp(cum_q,k) S_{k-1} + (B .
    exp(cum_q - cum))^T xdt, the chain along the chunks that the kernel's
    CTAs pass on to each other (its ``states`` scratch): the local states
    (``ssd_chunk_local_ref``) chained (``ssd_state_chain_ref``)."""
    cum, local = ssd_chunk_local_ref(xdt, loga, b, chunk)
    cb = torch.einsum("zkin,zkjn->zkij", _chunks(c, chunk), _chunks(b, chunk))
    return cum, cb, ssd_state_chain_ref(cum, local)


def ssd_chunk_out_ref(xdt: torch.Tensor, c: torch.Tensor, cum: torch.Tensor,
                      cb: torch.Tensor, states: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Launch 2, for every (row, chunk) at once: y = ((C B^T) . L) xdt +
    (C . exp(cum)) S_{k-1} (S_{-1} = 0), cut back to S. The masked decay
    takes 0 above the diagonal by selection."""
    bh, s, _ = xdt.shape
    x, cc = _chunks(xdt, chunk), _chunks(c, chunk)
    q = x.shape[2]
    lower = torch.ones(q, q, dtype=torch.bool, device=xdt.device).tril()
    decay = torch.where(lower, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        torch.zeros((), device=xdt.device))
    entering = torch.cat([torch.zeros_like(states[:, :1]), states[:, :-1]], dim=1)
    y = torch.einsum("zkij,zkjp->zkip", cb * decay, x)
    y = y + torch.einsum("zkin,zknp->zkip", cc * torch.exp(cum)[..., None], entering)
    return y.reshape(bh, -1, x.shape[-1])[:, :s]


def ssd_chunked_phases_ref(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, chunk: int = 128
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two launches composed: the function ``ssd_chunked_ref`` computes,
    in the CUDA kernels' order of work."""
    cum, cb, states = ssd_chunk_state_ref(xdt, loga, b, c, chunk)
    y = ssd_chunk_out_ref(xdt, c, cum, cb, states, chunk)
    return y.to(xdt.dtype), states[:, -1]


def ssd_decode_step(state: torch.Tensor, xdt: torch.Tensor, loga: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent token step (decode, O(1) per token): state (BH, N, P),
    xdt (BH, P), loga (BH,), b and c (BH, N) -> (y (BH, P), new state)."""
    state = torch.exp(loga)[:, None, None] * state + torch.einsum("bn,bp->bnp", b, xdt)
    y = torch.einsum("bn,bnp->bp", c, state)
    return y, state
