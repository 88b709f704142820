"""Relative entropy between degree and occurrence distributions (paper Eq. 6).

Numpy only: the host-side input of the walk-count gate
(``repro_torch.core.termination``), a copy of the reference's function.
"""

from __future__ import annotations

import numpy as np


def relative_entropy_dpq(degrees: np.ndarray, ocn: np.ndarray) -> float:
    """D(p || q) between degree and corpus-occurrence distributions (Eq. 6).

    Nodes with ocn == 0 are guarded with a small epsilon, mirroring an
    unconverged corpus (they push D up, demanding more walks).
    """
    deg = np.asarray(degrees, dtype=np.float64)
    occ = np.asarray(ocn, dtype=np.float64)
    sum_deg = deg.sum()
    sum_occ = occ.sum()
    if sum_deg == 0 or sum_occ == 0:
        return float("inf")
    p = deg / sum_deg
    q = occ / sum_occ
    mask = p > 0
    eps = 1e-12
    return float(np.sum(p[mask] * np.log2(p[mask] / (q[mask] + eps))))
