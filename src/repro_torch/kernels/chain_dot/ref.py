"""Plain-torch versions of the order-pinned scoring kernel (``chain_dot``).

A score is the dot product of two rows of phi taken as the JAX package's
``runtime/serve.py`` takes it: the d products as one elementwise op, then
an explicit chain of d - 1 adds in index order, each a separate op. Neither
op can be contracted into an FMA or reassociated, so the scores equal the
NumPy oracle (``runtime.serve.chain_dot``) bit for bit.

This is what the CUDA kernel (``csrc/chain_dot.cu``) is held against, and
what runs for tensors on the CPU. Ids are normalised as a JAX gather
normalises them: a negative id counts from the end, then ids clamp into
[0, N). ``topk_from_scores`` picks by a stable descending sort, so ties go
to the lower id as ``lax.top_k`` and ``oracle_topk`` break them
(``torch.topk`` does not).
"""

from __future__ import annotations

from typing import Tuple

import torch


def gather_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 row ids as a JAX gather reads them: negative ids count from
    the end, then every id clamps into [0, n)."""
    ids = ids.to(torch.int64)
    return torch.where(ids < 0, ids + n, ids).clamp(0, max(n - 1, 0))


def chain(prod: torch.Tensor) -> torch.Tensor:
    """The left-to-right add chain over the last axis: adds only."""
    acc = prod[..., 0]
    for j in range(1, prod.shape[-1]):
        acc = acc + prod[..., j]
    return acc


def pair_scores_ref(phi: torch.Tensor, u: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(N, d) phi, (B,) query ids, (B, C) candidate ids -> (B, C) scores."""
    n = phi.shape[0]
    return chain(phi[gather_ids(u, n)][:, None, :] * phi[gather_ids(cand, n)])


def all_scores_ref(phi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(N, d) phi, (B,) query ids -> (B, N) scores against every vertex."""
    return chain(phi[gather_ids(u, phi.shape[0])][:, None, :] * phi[None, :, :])


def topk_from_scores(scores: torch.Tensor, u: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) scores -> (values, int32 ids) of the k best, self excluded.

    Self is set to -inf; the order is a stable descending sort of
    ``scores + 0.0``, which maps -0.0 to +0.0 (NumPy and XLA hold the two
    equal; a radix sort on the card would order them apart). The values
    are gathered from the scores before that key was formed."""
    b, n = scores.shape
    scores = scores.clone()
    scores[torch.arange(b, device=scores.device), gather_ids(u, n).to(scores.device)] = \
        float("-inf")
    order = torch.sort(scores + 0.0, dim=1, descending=True, stable=True).indices[:, :k]
    return scores.gather(1, order), order.to(torch.int32)
