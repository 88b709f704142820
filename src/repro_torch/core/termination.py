"""Walk-count controller (paper Eq. 6–7): how many walks per node.

After each round r (one walk from every source node), HuGE compares the
node-degree distribution p(v) against the corpus-occurrence distribution
q(v) via relative entropy D_r(p||q) and stops when
|D_r - D_{r-1}| <= delta (delta = 0.001 in the paper).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.info import relative_entropy_dpq


@dataclasses.dataclass
class WalkCountController:
    """``window`` > 1 gates on the change of a WINDOWED MEAN of the D_r
    series instead of the raw round-to-round delta: at tight deltas the raw
    |D_r - D_{r-1}| sits inside the round-to-round sampling noise of the
    occurrence counts, and averaging the last ``window`` values attenuates
    that noise while leaving the convergence trend untouched.
    ``window=1`` is the exact paper-literal Eq. 7 gate.

    ``seed_history`` warm-starts the gate from a prior run's D_r series (the
    incremental refresh: after edge churn the refreshed corpus's D is judged
    against the converged pre-churn trajectory, with no ``min_rounds``
    burn-in). The windowed smoothing is replayed over the seed, so the first
    post-churn delta compares like with like."""

    delta: float = 1e-3
    min_rounds: int = 2
    max_rounds: int = 20
    window: int = 1
    seed_history: Optional[List[float]] = None

    def __post_init__(self):
        self.history: List[float] = []
        self._smooth: List[float] = []
        w = max(self.window, 1)
        for d in self.seed_history or ():
            self.history.append(float(d))
            self._smooth.append(float(np.mean(self.history[-w:])))

    def update(self, degrees: np.ndarray, ocn: np.ndarray) -> bool:
        """Record D_r for the corpus so far; return True if walking should
        CONTINUE (i.e. |Delta D_r| > delta or not enough rounds yet)."""
        return self.update_d(relative_entropy_dpq(degrees, ocn))

    def update_d(self, d_r: float) -> bool:
        """Decision half of ``update`` for callers that compute D_r
        themselves (the streaming pipeline, which reads ocn back once per
        round for the alias table anyway)."""
        self.history.append(float(d_r))
        w = max(self.window, 1)
        self._smooth.append(float(np.mean(self.history[-w:])))
        r = len(self.history)
        if r < self.min_rounds:
            return True
        if r >= self.max_rounds:
            return False
        delta_d = abs(self._smooth[-1] - self._smooth[-2])
        return bool(delta_d > self.delta)

    @property
    def rounds(self) -> int:
        return len(self.history)

    # --- the snapshot surface ------------------------------------------------
    def to_state(self) -> dict:
        """JSON-serializable gate state for pipeline snapshots: the
        configuration and the whole D_r history (the windowed smoothing is a
        pure function of the history, so it is replayed on restore)."""
        return {
            "delta": float(self.delta),
            "min_rounds": int(self.min_rounds),
            "max_rounds": int(self.max_rounds),
            "window": int(self.window),
            "history": [float(d) for d in self.history],
        }

    @classmethod
    def from_state(cls, state: dict) -> "WalkCountController":
        """Rebuild a gate mid-trajectory: the ``seed_history`` replay gives
        the same smoothed series the live gate accumulated, so the first
        decision after a restore is the uninterrupted run's."""
        return cls(delta=state["delta"], min_rounds=state["min_rounds"],
                   max_rounds=state["max_rounds"], window=state["window"],
                   seed_history=list(state["history"]))
