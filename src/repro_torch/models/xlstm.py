"""xLSTM blocks: the mLSTM (matrix memory, a chunked SSD scan) and the
sLSTM (scalar memory with a true time recurrence), the "x" and "s"
entries of ``block_cycle``. Forward only.

The port of the JAX package's ``models/xlstm.py``. The mLSTM maps onto
the SSD scan: with key k_t, value v_t, query q_t and gates i_t (input)
and f_t (forget),

    C_t = f_t C_{t-1} + i_t v_t k_t^T      == SSD with loga = log f,
    n_t = f_t n_{t-1} + i_t k_t               xdt = [i v ‖ i], B = k, C = q
    y_t = (C_t q_t) / max(|n_t . q_t|, 1)

so the normaliser n rides along as one extra value column (P + 1). The
prefill scans through ``kernels.ssm_scan.ssd_scan_heads``, each head its
own group (G = H): on the card that is K3's wide route at the xLSTM's
shape (P = 513, N = 512, chunk 512), reading xdt, loga, k and q in the
mixer's (B, S, H, ·) layout through strided views and writing y in it,
xdt's and y's rows padded to 516 floats so that each starts on 16 bytes; on
the CPU its plain version, the reference's ``ssd_chunked_ref``. Decode
steps the (B, H, N, P + 1) state with the plain ``ssd_decode_step``, as
the reference does outside any kernel. Types follow the reference: q, k
and v in the model dtype (k / sqrt(P) too, sqrt(P) rounded to that dtype first, as
the reference's weak-typed scalar is), then float32 for the scan;
the gates in float32 from float32 weights; y cast to the model dtype
before the sigmoid output gate and the RMSNorm.

The sLSTM keeps per-unit scalar cells with recurrent gate connections (h
@ R), a strict recurrence over time: a plain torch loop over
``_slstm_step``, one step per token, inside a ``torch.autograd.Function``
(``_SLSTMScan``) whose backward is the reference's ``custom_vjp``: the
gate activations recomputed batched over time, one reverse loop, and dR
as one batched product over the whole series (autograd through the loop
would keep a graph of S steps). The forward keeps the c and n series only
when a gradient is wanted.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.context import constrain_scan_inputs
from repro_torch.kernels.ssm_scan.ops import ssd_scan_heads
from repro_torch.kernels.ssm_scan.ref import ssd_decode_step
from repro_torch.kernels.ssm_scan.wide import empty_aligned
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, init_rmsnorm, rmsnorm

Params = Dict[str, Any]
EPS = 1e-6


def _mdims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or cfg.num_heads
    return d_in, nh, d_in // nh


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    d_in, nh, _ = _mdims(cfg)
    return {
        "wq": dense_init(gen, (d, d_in), dtype, device),
        "wk": dense_init(gen, (d, d_in), dtype, device),
        "wv": dense_init(gen, (d, d_in), dtype, device),
        "wi": dense_init(gen, (d, nh), torch.float32, device),
        "wf": dense_init(gen, (d, nh), torch.float32, device),
        "wo_gate": dense_init(gen, (d, d_in), dtype, device),
        "norm": init_rmsnorm(d_in, dtype, device),
        "out_proj": dense_init(gen, (d_in, d), dtype, device),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    """The matrix memory and its normaliser column, (B, H, N, P + 1) float32."""
    _, nh, p_dim = _mdims(cfg)
    return torch.zeros(batch, nh, p_dim, p_dim + 1, dtype=torch.float32, device=device)


def values_ext(v: torch.Tensor, i_gate: torch.Tensor) -> torch.Tensor:
    """The values extended with the normaliser column, [v ‖ 1] i, float32 in
    the mixer's (B, S, nh, P + 1): a view of a buffer whose last dim is
    padded to a multiple of 4, so that every row starts on 16 bytes, as K3's
    wide route reads them (it copies rows that do not). Each entry is the
    float32 product v i (i itself in the last column), as
    ``cat([v, 1]) * i`` gives it."""
    bsz, s, nh, p_dim = v.shape
    ext = empty_aligned((bsz, s, nh, p_dim + 1), v.device)
    ext[..., :p_dim] = v.float() * i_gate[..., None]
    ext[..., p_dim] = i_gate
    return ext


def mlstm_mixer(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                state: Optional[torch.Tensor] = None,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), new state or None). ``state`` given:
    one decode step (S == 1) from it; else a prefill, which returns its
    final state when ``return_state``."""
    bsz, s, _ = x.shape
    d_in, nh, p_dim = _mdims(cfg)
    q = (x @ p["wq"]).reshape(bsz, s, nh, p_dim)
    k = (x @ p["wk"]).reshape(bsz, s, nh, p_dim)
    v = (x @ p["wv"]).reshape(bsz, s, nh, p_dim)
    # the reference divides by sqrt(P) as a weak-typed scalar, which JAX
    # rounds to the model dtype first (22.625 in bf16, not 22.6274)
    k = k / float(torch.tensor(p_dim ** 0.5, dtype=k.dtype))
    xf = x.float()
    i_gate = torch.exp(-F.softplus(-(xf @ p["wi"])))            # (B, S, nh)
    f_gate = torch.sigmoid(xf @ p["wf"])
    loga = torch.log(torch.clamp_min(f_gate, 1e-6))

    v_ext = values_ext(v, i_gate)
    b_f, c_f = k.float(), q.float()

    new_state = None
    if state is None:
        # prefill: every head its own group; (B, nh, S, ·) views of the
        # (B, S, nh, ·) tensors, y back as a view of a (B, S, nh, P + 1) tensor
        y_h, s_fin = ssd_scan_heads(v_ext.transpose(1, 2), loga.transpose(1, 2),
                                    b_f.transpose(1, 2), c_f.transpose(1, 2),
                                    chunk=cfg.ssm_chunk)
        y_ext = y_h.transpose(1, 2)                              # (B, S, nh, P + 1)
        if return_state:
            new_state = s_fin
    else:
        bh = bsz * nh
        y_one, new_s = ssd_decode_step(
            state.reshape(bh, p_dim, p_dim + 1), v_ext[:, 0].reshape(bh, p_dim + 1),
            loga[:, 0].reshape(bh), b_f[:, 0].reshape(bh, p_dim),
            c_f[:, 0].reshape(bh, p_dim))
        y_ext = y_one.reshape(bsz, 1, nh, p_dim + 1)
        new_state = new_s.reshape(bsz, nh, p_dim, p_dim + 1)

    y = y_ext[..., :p_dim] / torch.clamp_min(torch.abs(y_ext[..., -1:]), 1.0)
    y = y.reshape(bsz, s, d_in)
    o = torch.sigmoid(x @ p["wo_gate"])
    y = rmsnorm(y.to(x.dtype) * o, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    return {
        "w": dense_init(gen, (d, 4 * d), torch.float32, device),     # z, i, f, o
        "r": dense_init(gen, (d, 4 * d), torch.float32, device, scale=0.1),
        "b": torch.zeros(4 * d, dtype=torch.float32, device=device),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> Params:
    z = torch.zeros(batch, cfg.d_model, dtype=torch.float32, device=device)
    return {"c": z, "n": z + EPS, "h": z.clone()}


def _slstm_step(c, n, h, wx_t, r):
    """One time step of the cell: wx_t (B, 4d) the input's gate
    pre-activations, h @ r the recurrent ones."""
    gates = wx_t + h @ r
    zp, ip, fp, op = torch.chunk(gates, 4, dim=-1)
    z_t = torch.tanh(zp)
    i_t = torch.sigmoid(ip)        # exp(-softplus(-x)) == sigmoid(x)
    f_t = torch.sigmoid(fp)
    o_t = torch.sigmoid(op)
    c = f_t * c + i_t * z_t
    n = f_t * n + i_t
    h = o_t * c / torch.clamp_min(n, EPS)
    return c, n, h


class _SLSTMScan(torch.autograd.Function):
    """(wx (B, S, 4d), r, c0, n0, h0) -> (hs (B, S, d), c, n, h), float32:
    the loop forward, the reference's ``_slstm_bwd`` backward."""

    @staticmethod
    def forward(ctx, wx, r, c, n, h):
        bsz, s, _ = wx.shape
        keep = any(ctx.needs_input_grad)
        series = lambda: torch.empty(bsz, s, c.shape[-1], dtype=torch.float32, device=wx.device)
        hs = series()
        cs, ns = (series(), series()) if keep else (None, None)
        init = (c, n, h)
        for t in range(s):
            c, n, h = _slstm_step(c, n, h, wx[:, t], r)
            hs[:, t] = h
            if keep:
                cs[:, t], ns[:, t] = c, n
        if keep:
            ctx.save_for_backward(wx, r, *init, hs, cs, ns)
        return hs, c, n, h

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh):
        wx, r, c0, n0, h0, hs, cs, ns = ctx.saved_tensors
        # the series one step back: the values feeding step t
        h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
        c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
        n_prev = torch.cat([n0[:, None], ns[:, :-1]], dim=1)
        pre = wx + h_prev @ r
        zp, ip, fp, op = torch.chunk(pre, 4, dim=-1)
        z, i, f, o = torch.tanh(zp), torch.sigmoid(ip), torch.sigmoid(fp), torch.sigmoid(op)
        dpres = torch.empty_like(wx)
        for t in reversed(range(wx.shape[1])):
            dh_t = dh + dhs[:, t]
            c_t, n_t, o_t, f_t, i_t, z_t = cs[:, t], ns[:, t], o[:, t], f[:, t], i[:, t], z[:, t]
            nmax = torch.clamp_min(n_t, EPS)
            do = dh_t * c_t / nmax
            dc_t = dc + dh_t * o_t / nmax
            dn_t = dn - torch.where(n_t > EPS, dh_t * o_t * c_t / (nmax * nmax), 0.0)
            # c_t = f c_{t-1} + i z ;  n_t = f n_{t-1} + i
            df = dc_t * c_prev[:, t] + dn_t * n_prev[:, t]
            di = dc_t * z_t + dn_t
            dz = dc_t * i_t
            dpre = torch.cat([dz * (1 - z_t * z_t), di * i_t * (1 - i_t),
                              df * f_t * (1 - f_t), do * o_t * (1 - o_t)], dim=-1)
            dpres[:, t] = dpre
            dh = dpre @ r.T
            dc = dc_t * f_t
            dn = dn_t * f_t
        dr = torch.einsum("bsd,bsk->dk", h_prev, dpres)
        return dpres, dr, dc, dn, dh


def slstm_mixer(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                state: Optional[Params] = None,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) -> (h for every step (B, S, d) in x's dtype, the final
    {c, n, h} or None). Starts from ``state`` when given (decode), else
    from c = h = 0, n = 1e-6; returns the final state when given one or
    when ``return_state``."""
    bsz, s, d = x.shape
    wx = x.float() @ p["w"] + p["b"]                             # (B, S, 4d)
    wx = constrain_scan_inputs(wx, batch_dim=0)     # the recurrence's steps stay on one rank
    if state is None:
        init = init_slstm_state(cfg, bsz, x.device)
        c, n, h = init["c"], init["n"], init["h"]
    else:
        c, n, h = state["c"], state["n"], state["h"]
    hs, c, n, h = _SLSTMScan.apply(wx, p["r"], c, n, h)
    keep = state is not None or return_state
    return hs.to(x.dtype), ({"c": c, "n": n, "h": h} if keep else None)
