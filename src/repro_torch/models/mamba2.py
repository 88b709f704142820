"""Mamba2 mixer block (scalar-identity A, SSD scan): zamba2's "m" blocks.

The port of the JAX package's ``models/mamba2.py``. Per block (Mamba2,
n_groups=1):
  in_proj -> [z (gate), x, B, C, dt] ;  causal depthwise conv over [x,B,C] ;
  dt = softplus(dt + bias) ; loga = -exp(A_log) * dt (per head) ;
  y = SSD_scan(x*dt, loga, B, C) + D*x ;  y = RMSNorm(y * silu(z)) ;
  out_proj.

Prefill scans through ``kernels.ssm_scan.ssd_scan_heads``: on the card
that is the CUDA kernels, which read xdt and loga in the mixer's (B, S,
nh, ·) layout and B and C once per batch, and write y in that layout; on
the CPU its plain version, B and C expanded to every head (the reference
broadcasts them and calls the jnp ``ssd_chunked_ref``, the same
function). Decode keeps (conv state, ssm state) and steps them with the
plain ``ssd_decode_step``, O(1) per token, as the reference does outside
any kernel. Types follow the reference: dt, loga and xdt in float32, the
conv window and its state in the model dtype, y + D*x in float32 and cast
to the model dtype before the gated RMSNorm.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import ssd_scan_heads
from repro_torch.kernels.ssm_scan.ref import ssd_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, init_rmsnorm, rmsnorm

Params = Dict[str, Any]


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or max(d_in // max(cfg.ssm_head_dim, 1), 1)
    p_dim = d_in // nh
    return d_in, nh, p_dim, cfg.ssm_state


def init_mamba(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    d_in, nh, p_dim, n = _dims(cfg)
    conv_ch = d_in + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * n + nh), dtype, device),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dtype, device, scale=0.5),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.zeros(nh, **f32),
        "D": torch.ones(nh, **f32),
        "dt_bias": torch.zeros(nh, **f32),
        "norm": init_rmsnorm(d_in, dtype, device),
        "out_proj": dense_init(gen, (d_in, d), dtype, device),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    d_in, nh, p_dim, n = _dims(cfg)
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, d_in + 2 * n, dtype=dtype, device=device),
        "ssm": torch.zeros(batch, nh, n, p_dim, dtype=torch.float32, device=device),
    }


def _split_proj(z_all, d_in, n, nh):
    return torch.split(z_all, [d_in, d_in, n, n, nh], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. x: (B, S, C); w: (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return F.silu(out + b)


def mamba_mixer(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                state: Optional[Params] = None,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) -> (out (B, S, d), new state or None). ``state`` given:
    one decode step (S == 1) from it; else a prefill, which returns its
    final state when ``return_state``."""
    bsz, s, _ = x.shape
    d_in, nh, p_dim, n = _dims(cfg)
    z, xc, b, c, dt = _split_proj(x @ p["in_proj"], d_in, n, nh)

    conv_in = torch.cat([xc, b, c], dim=-1)                   # (B, S, d_in + 2N)
    k = cfg.ssm_conv
    new_state = None
    if state is None:
        conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    else:
        window = torch.cat([state["conv"], conv_in], dim=1)   # roll the conv window
        conv_out = F.silu(torch.einsum("bkc,kc->bc", window[:, -k:], p["conv_w"])
                          + p["conv_b"])[:, None, :]
        new_conv = window[:, -(k - 1):]

    xs, bs, cs = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, S, nh)
    loga = -torch.exp(p["A_log"]) * dt                         # (B, S, nh)
    xh = xs.reshape(bsz, -1, nh, p_dim)
    xdt = xh.float() * dt[..., None]

    bh = bsz * nh
    if state is None:
        # prefill: chunked SSD over (batch, head) rows, read in place as
        # (B, nh, S, ·) views; B and C once per batch (one group)
        y_h, s_fin = ssd_scan_heads(xdt.transpose(1, 2), loga.transpose(1, 2),
                                    bs.float()[:, None], cs.float()[:, None],
                                    chunk=cfg.ssm_chunk)
        y = y_h.transpose(1, 2)                                # (B, S, nh, P)
        if return_state:
            tail = conv_in[:, -(k - 1):]
            pad = k - 1 - tail.shape[1]
            if pad > 0:
                tail = F.pad(tail, (0, 0, pad, 0))
            new_state = {"conv": tail, "ssm": s_fin}
    else:
        # decode: one recurrent step (S == 1)
        y_f, new_ssm = ssd_decode_step(
            state["ssm"].reshape(bh, n, p_dim),
            xdt[:, 0].reshape(bh, p_dim),
            loga[:, 0].reshape(bh),
            bs[:, 0, None].float().expand(bsz, nh, n).reshape(bh, n),
            cs[:, 0, None].float().expand(bsz, nh, n).reshape(bh, n))
        y = y_f.reshape(bsz, 1, nh, p_dim)
        new_state = {"conv": new_conv, "ssm": new_ssm.reshape(bsz, nh, n, p_dim)}

    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, -1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state
