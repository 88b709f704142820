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

``sgns_step_ref`` is the whole DSGL step around it, as
``repro.core.dsgl._replica_step`` runs it: gather the rows by id, update,
then write the deltas back duplicate-averaged. The write-back touches the
live slots only (a valid walk token, or a negative at a position where some
walk has a valid target): every other slot's delta is exactly zero. The
counts stay the reference's: phi_in counts the valid walk tokens, phi_out
the valid walk tokens plus every negative slot, at dead positions too.
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


# ---------------------------------------------------------------------------
# The DSGL step: gather -> lifetime update -> live-row write-back
# ---------------------------------------------------------------------------


def live_slots(walks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, G, W, T) walk ids -> the live walk slots (S, G, W, T) (a valid
    token) and the live positions (S, G, T) (some walk has a valid target
    there; the negatives of these positions are live)."""
    valid = walks >= 0
    return valid, valid.any(dim=-2)


def lifetime_extent(walks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., W, T) walk ids -> the first and last live position of each
    lifetime (...,), both -1 where no position is live: the positions the
    kernel visits."""
    live = (walks >= 0).any(dim=-2)
    t_len = live.shape[-1]
    pos = torch.arange(t_len, device=walks.device)
    lo = torch.where(live, pos, t_len).amin(dim=-1)
    hi = torch.where(live, pos, -1).amax(dim=-1)
    return torch.where(hi >= 0, lo, -1), hi


def lifetime_deltas_ref(phi_in, phi_out, walks, negs, lr, window: int):
    """The lifetime kernel's function: rows gathered by id from phi (S, N, d),
    updated per lifetime. Returns the deltas (final - initial) of every walk
    slot's context row (S, G, W, T, d), target row (S, G, W, T, d), and
    negative slot (S, G, T, K, d), and the loss per lifetime (S * G,)."""
    s_cnt, g_cnt, w_cnt, t_len = walks.shape
    safe = walks.clamp_min(0).to(torch.int64)
    rep = torch.arange(s_cnt, device=walks.device)[:, None, None, None]
    ctx0 = phi_in[rep, safe]
    out0 = phi_out[rep, safe]
    neg0 = phi_out[rep, negs.to(torch.int64)]
    merge = lambda a: a.reshape(s_cnt * g_cnt, *a.shape[2:])
    ctx, out, neg, loss = sgns_lifetime_batch_ref(merge(ctx0), merge(out0), merge(neg0),
                                                  merge(walks >= 0), lr, window)
    return (ctx.view_as(ctx0) - ctx0, out.view_as(out0) - out0,
            neg.view_as(neg0) - neg0, loss)


def write_back_ref(phi_in, phi_out, walks, negs, d_ctx, d_out, d_neg) -> None:
    """phi[id] += delta / count(id), in place, over the live slots only."""
    s_cnt, n_rows, dim = phi_in.shape
    valid, pos_live = live_slots(walks)
    off = (torch.arange(s_cnt, device=walks.device) * n_rows)[:, None, None, None]
    wid = walks.to(torch.int64) + off
    nid = negs.to(torch.int64) + off
    flat_in, flat_out = phi_in.view(-1, dim), phi_out.view(-1, dim)
    live_w = wid[valid]
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=walks.device)
    cnt_in = torch.zeros(s_cnt * n_rows, device=walks.device).index_add_(
        0, live_w, ones(live_w.numel()))
    all_out = torch.cat([live_w, nid.reshape(-1)])
    cnt_out = torch.zeros(s_cnt * n_rows, device=walks.device).index_add_(
        0, all_out, ones(all_out.numel()))
    inv = lambda cnt, ids: (1.0 / cnt[ids].clamp_min(1.0))[:, None]
    flat_in.index_add_(0, live_w, d_ctx[valid] * inv(cnt_in, live_w))
    neg_live = pos_live[..., None].expand(nid.shape)
    out_ids = torch.cat([live_w, nid[neg_live]])
    flat_out.index_add_(0, out_ids, torch.cat([d_out[valid], d_neg[neg_live]])
                        * inv(cnt_out, out_ids))


def sgns_step_ref(phi_in, phi_out, walks, negs, lr, window: int) -> torch.Tensor:
    """One DSGL step over S replicas, phi (S, N, d) updated in place: gather,
    lifetime update, live-row write-back. Returns the loss per replica (S,)."""
    d_ctx, d_out, d_neg, loss = lifetime_deltas_ref(phi_in, phi_out, walks, negs, lr, window)
    write_back_ref(phi_in, phi_out, walks, negs, d_ctx, d_out, d_neg)
    return loss.view(walks.shape[0], walks.shape[1]).sum(dim=1)
