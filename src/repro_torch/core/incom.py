"""InCoM — incremental information-centric computing (paper §3.1).

The walker's information state is the ten scalars of Example 1; this
module keeps the seven that evolve, batched over walkers:

* Theorem 1 / Eq. 8 — O(1) incremental entropy update,
* Eq. 13 — O(1) incremental running means / cross-moment (with the
  cross-moment erratum fix documented in ``repro_torch.core.info``),
* Eq. 12 — R(H, L) from the running expectations.

The ten scalars are also the constant-size message a walker carries
across shards (``MSG_FIELDS``: 80 bytes at 8 bytes a field, Example 1);
the HuGE-D baseline ships its whole walk instead (24 + 8L bytes).

``n(v)`` is a masked count over the walker's fixed-length path buffer.
The arithmetic is the reference's, op for op; only ``log2`` differs in
its last bits between torch and XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Message layout of the constant-size InCoM cross-shard message.
MSG_FIELDS = (
    "walker_id", "steps", "node_id", "H", "L",
    "EH", "EL", "EHL", "EH2", "EL2",
)
MSG_WIDTH = len(MSG_FIELDS)          # 10 fields
MSG_BYTES = 8 * MSG_WIDTH            # 80 bytes (Example 1)


def fullpath_msg_bytes(walk_len):
    """HuGE-D message size: 24 + 8L bytes (Example 1)."""
    return 24 + 8 * walk_len


@dataclasses.dataclass
class InfoState:
    """Per-walker incremental information state (all shape (B,), float32).

    ``L`` is the current walk length (number of nodes, source included).
    The running expectations are over the series {(L_i, H_i)}_{i=1..L},
    seeded with the initial point (L=1, H=0).
    """

    H: torch.Tensor
    L: torch.Tensor
    EH: torch.Tensor
    EL: torch.Tensor
    EHL: torch.Tensor
    EH2: torch.Tensor
    EL2: torch.Tensor

    @classmethod
    def init(cls, batch: int, device) -> "InfoState":
        z = torch.zeros(batch, dtype=torch.float32, device=device)
        one = torch.ones(batch, dtype=torch.float32, device=device)
        return cls(H=z, L=one, EH=z, EL=one, EHL=z, EH2=z, EL2=one)

    def where(self, mask: torch.Tensor, other: "InfoState") -> "InfoState":
        """Field-wise ``torch.where(mask, self, other)``."""
        return InfoState(**{
            f.name: torch.where(mask, getattr(self, f.name), getattr(other, f.name))
            for f in dataclasses.fields(self)})


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    """x * log2(x) with the 0*log(0) = 0 convention."""
    safe = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, x * torch.log2(safe), 0.0)


def entropy_step(H: torch.Tensor, L: torch.Tensor, n_v: torch.Tensor) -> torch.Tensor:
    """Theorem 1: H(W^{L+1}) from H(W^L), L, and n(v) of the accepted node.

        H^{L+1} = (H^L * L - log2 T) / (L + 1)
        log2 T  = L log2 L - (L+1) log2 (L+1) + (n+1) log2 (n+1) - n log2 n
    """
    n = n_v.to(torch.float32)
    log_t = _xlogx(L) - _xlogx(L + 1.0) + _xlogx(n + 1.0) - _xlogx(n)
    return (H * L - log_t) / (L + 1.0)


def stats_step(s: InfoState, h_new: torch.Tensor, l_new: torch.Tensor,
               reg_start: int = 1) -> InfoState:
    """Eq. 13 running updates with the new series point (l_new, h_new),
    the regression series starting at length L0 = ``reg_start``."""
    p = torch.clamp_min(l_new - float(reg_start) + 1.0, 1.0)
    w_prev = (p - 1.0) / p
    return InfoState(
        H=h_new,
        L=l_new,
        EH=w_prev * s.EH + h_new / p,
        EL=w_prev * s.EL + l_new / p,
        EHL=(w_prev * s.EHL) + (h_new * l_new) / p,
        EH2=(w_prev * s.EH2) + (h_new * h_new) / p,
        EL2=(w_prev * s.EL2) + (l_new * l_new) / p,
    )


def r_squared(s: InfoState, eps: float = 1e-12) -> torch.Tensor:
    """Eq. 12: R^2(H, L) from the running expectations."""
    cov = s.EHL - s.EH * s.EL
    vh = torch.clamp_min(s.EH2 - s.EH * s.EH, 0.0)
    vl = torch.clamp_min(s.EL2 - s.EL * s.EL, 0.0)
    denom = vh * vl
    return torch.where(denom > eps, (cov * cov) / torch.clamp_min(denom, eps), 0.0)


def windowed_r_squared(hring: torch.Tensor, L: torch.Tensor, window: int,
                       eps: float = 1e-12) -> torch.Tensor:
    """R^2(H, L) over the last ``window`` series points, from a ring buffer:
    ``hring`` is (B, K) and slot (s - 1) mod K holds H(W^s). Constant-size
    messages of 80 + 8K bytes (the ring rides along)."""
    k = hring.shape[1]
    offs = torch.arange(k, dtype=torch.float32, device=hring.device)[None, :]
    l_pts = L[:, None] - offs                                  # L, L-1, ...
    valid = (l_pts >= 1.0) & (offs < float(window))
    slot = torch.remainder(l_pts.to(torch.int32) - 1, k)
    h_pts = torch.gather(hring, 1, slot.clamp(0, k - 1).to(torch.int64))
    w = valid.to(torch.float32)
    cnt = torch.clamp_min(w.sum(-1), 1.0)
    eh = (h_pts * w).sum(-1) / cnt
    el = (l_pts * w).sum(-1) / cnt
    ehl = (h_pts * l_pts * w).sum(-1) / cnt
    eh2 = (h_pts * h_pts * w).sum(-1) / cnt
    el2 = (l_pts * l_pts * w).sum(-1) / cnt
    cov = ehl - eh * el
    vh = torch.clamp_min(eh2 - eh * eh, 0.0)
    vl = torch.clamp_min(el2 - el * el, 0.0)
    denom = vh * vl
    return torch.where(denom > eps, cov * cov / torch.clamp_min(denom, eps), 0.0)


def count_in_path(path: torch.Tensor, length: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """n(v): occurrences of v among the first ``length`` entries of ``path``.

    path: (B, max_len) int32, padded with -1; length: (B,); v: (B,)."""
    pos = torch.arange(path.shape[-1], device=path.device)[None, :]
    hit = (path == v[:, None]) & (pos < length[:, None])
    return hit.sum(dim=-1)


def accept_update(
    s: InfoState,
    path: torch.Tensor,
    v: torch.Tensor,
    reg_start: int = 1,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[InfoState, torch.Tensor]:
    """Apply one accepted step: n(v), H^{L+1}, running stats, and the path
    with v appended at position L (on ``mask`` lanes only; an append past
    the buffer writes nothing)."""
    n_v = count_in_path(path, s.L.to(torch.int64), v)
    h_new = entropy_step(s.H, s.L, n_v)
    s_new = stats_step(s, h_new, s.L + 1.0, reg_start)
    pos = torch.arange(path.shape[1], device=path.device)[None, :]
    hit = pos == s.L.to(torch.int64)[:, None]
    if mask is not None:
        hit = hit & mask[:, None]
    path_new = torch.where(hit, v[:, None].to(path.dtype), path)
    return s_new, path_new


# Ring rows per pass of the corpus scans below: bounds their int64 pair codes
# to ~50 MB at max_len 100, whatever the ring's size.
SCAN_ROWS = 1 << 16


def paths_traverse_edges(paths: torch.Tensor, edge_codes: torch.Tensor,
                         num_nodes: int) -> torch.Tensor:
    """Which recorded walks traverse any of a set of (changed) arcs.

    paths:      (B, max_len) int32, -1 padded walk buffers (the corpus).
    edge_codes: (m,) sorted int64 row-major arc codes u * num_nodes + v
                (both directions of an undirected edge).

    Returns (B,) bool, on the paths' device. The corpus half of the
    incremental refresh: staleness is read off the recorded paths by one
    consecutive-pair membership test, no walk re-simulated. The codes are
    int64 at every |V| (the reference switches to a host int64 route once
    |V|² reaches 2³¹; the answers are the same), and the rows are scanned
    ``SCAN_ROWS`` at a time."""
    out = torch.zeros(paths.shape[0], dtype=torch.bool, device=paths.device)
    m = int(edge_codes.shape[0])
    if m == 0:
        return out
    codes = edge_codes.to(paths.device, torch.int64)
    for lo in range(0, paths.shape[0], SCAN_ROWS):
        p = paths[lo:lo + SCAN_ROWS].to(torch.int64)
        a, b = p[:, :-1], p[:, 1:]
        code = a.clamp_min(0) * num_nodes + b.clamp_min(0)
        pos = torch.searchsorted(codes, code.reshape(-1)).clamp_max(m - 1)
        hit = (codes[pos] == code.reshape(-1)).reshape(code.shape) & (a >= 0) & (b >= 0)
        out[lo:lo + SCAN_ROWS] = hit.any(dim=1)
    return out


def paths_visit_nodes(paths: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Which recorded walks visit any marked node; ``node_mask`` (|V|,) bool.

    The paranoid detector's criterion: a walk that visits nothing in the
    closed neighbourhood of the churn draws the same candidates and
    acceptance inputs on the mutated graph, so it is provably unchanged."""
    out = torch.zeros(paths.shape[0], dtype=torch.bool, device=paths.device)
    mask = node_mask.to(paths.device)
    for lo in range(0, paths.shape[0], SCAN_ROWS):
        p = paths[lo:lo + SCAN_ROWS].to(torch.int64)
        out[lo:lo + SCAN_ROWS] = (mask[p.clamp_min(0)] & (p >= 0)).any(dim=1)
    return out
