"""Plain-torch version of the fused SGNS lifetime update.

Semantics (those of ``repro.kernels.sgns.ref``): for each position p of a
lifetime of W walks,

    contexts  C = ctx_buf[:, p-w..p+w (excl p), :]      (W*2w, d)  phi_in rows
    targets/negs T = [out_buf[:, p, :] ; neg_buf[p]]    (W+K, d)   phi_out rows
    logits = clip(C @ T^T, +-6)  (word2vec MAX_EXP)
    g      = (Y - sigmoid(logits)) * masks
    C += lr * g @ T ;  T += lr * g^T @ C_old

This is what the CUDA kernel (``csrc/sgns_lifetime.cu``) is held against,
and what runs for tensors on the CPU. The positions run in order; the
lifetimes (G) are a batch axis.
"""

from __future__ import annotations

from typing import Tuple

import torch

MAX_EXP = 6.0
EPS = 1e-7


def sgns_lifetime_batch_ref(
    ctx: torch.Tensor,    # (G, W, T, d) f32
    out: torch.Tensor,    # (G, W, T, d) f32
    neg: torch.Tensor,    # (G, T, K, d) f32
    valid: torch.Tensor,  # (G, W, T) bool
    lr: float,
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns the updated (ctx, out, neg) buffers and the loss per lifetime (G,)."""
    g_cnt, w_cnt, t_len, dim = ctx.shape
    k = neg.shape[2]
    dev = ctx.device
    ctx, out, neg = ctx.clone(), out.clone(), neg.clone()
    valid = valid.to(torch.bool)
    offs = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)]).to(dev)
    n_rows = w_cnt * offs.shape[0]
    walk_of_row = torch.arange(w_cnt, device=dev).repeat_interleave(offs.shape[0])
    y = torch.nn.functional.one_hot(walk_of_row, w_cnt + k).to(torch.float32)
    ones_k = torch.ones(g_cnt, k, device=dev)
    loss = torch.zeros(g_cnt, device=dev)
    for p in range(t_len):
        idx = p + offs
        in_bounds = (idx >= 0) & (idx < t_len)
        idx_c = idx.clamp(0, t_len - 1)
        c_flat = ctx[:, :, idx_c, :].reshape(g_cnt, n_rows, dim)
        c_valid = in_bounds & valid[:, :, idx_c]                    # (G, W, 2w)
        tgt_valid = valid[:, :, p]                                  # (G, W)
        t_rows = torch.cat([out[:, :, p, :], neg[:, p]], dim=1)     # (G, W+K, d)
        logits = torch.clamp(c_flat @ t_rows.transpose(1, 2), -MAX_EXP, MAX_EXP)
        sig = torch.sigmoid(logits)
        row_mask = (c_valid.reshape(g_cnt, n_rows)
                    & tgt_valid[:, walk_of_row]).to(torch.float32)
        col_mask = torch.cat([tgt_valid.to(torch.float32), ones_k], dim=1)
        mask = row_mask[:, :, None] * col_mask[:, None, :]
        g = (y - sig) * mask
        pair_loss = -(y * torch.log(sig + EPS) + (1 - y) * torch.log(1 - sig + EPS))
        loss = loss + (pair_loss * mask).sum(dim=(1, 2))
        d_c = (g @ t_rows) * lr                                     # (G, 2wW, d)
        d_t = (g.transpose(1, 2) @ c_flat) * lr                     # (G, W+K, d)
        # Clipped duplicate indices carry zero rows: accumulate, as .at[].add.
        ctx.index_add_(2, idx_c, d_c.reshape(g_cnt, w_cnt, -1, dim))
        out[:, :, p, :] += d_t[:, :w_cnt]
        neg[:, p] += d_t[:, w_cnt:]
    return ctx, out, neg, loss


def sgns_lifetime_ref(ctx_buf, out_buf, neg_buf, valid, lr: float, window: int):
    """One lifetime: (W, T, d), (W, T, d), (T, K, d), (W, T) -> buffers + loss."""
    res = sgns_lifetime_batch_ref(ctx_buf[None], out_buf[None], neg_buf[None],
                                  valid[None], lr, window)
    return tuple(r[0] for r in res)
