"""Plain PyTorch attention (GQA, optional causal): the flash kernel's plain
versions, ported from the JAX package's ``kernels/flash_attention/ref.py``.

``mha_reference`` materialises the (Sq, Skv) scores and keeps the
probabilities in float32 for P·V, as the flash kernel does.
``mha_chunked`` walks query chunks so the scores are never whole, and
rounds the probabilities to the model dtype before P·V, as the
reference's chunked path does.
"""

from __future__ import annotations

import torch


def mha_reference(q, k, v, *, causal: bool = True, sm_scale: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's dtype.

    ``q_offset`` places the query block inside the kv sequence for the
    causal mask (decode: q_offset = cache_len - Sq)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        kv_pos = torch.arange(skv, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def mha_chunked(q, k, v, *, causal: bool = True, sm_scale: float | None = None,
                q_offset: int = 0, block_q: int = 512) -> torch.Tensor:
    """Attention over query chunks of ``block_q``: the peak transient is
    (B, H, block_q, Skv). Scores, max and sum in float32; the
    probabilities in the model dtype for P·V."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    bq = min(block_q, sq)
    kv_pos = torch.arange(skv, device=q.device)
    kf, vd = k.float(), v.to(q.dtype)
    outs = []
    for lo in range(0, sq, bq):
        qc = q[:, :, lo:lo + bq].reshape(b, hkv, group, -1, d)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc.float(), kf) * sm_scale
        if causal:
            q_pos = lo + torch.arange(qc.shape[3], device=q.device) + q_offset
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask[None, None, None], s, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vd).reshape(b, hq, -1, d))
    return torch.cat(outs, dim=2).to(q.dtype)
