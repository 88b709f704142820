"""The paper's own workload: DistGER graph-embedding runs (§6.1 parameters).

mu=0.995, delta=0.001, dim=128, window=10, K=5 negatives, multi_windows=2.
Graph presets mirror the paper's table-2 datasets
as R-MAT stand-ins of the same |V| and average degree (the real
FL/YT/LJ/OR/TW downloads are not bundled).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.api import EmbedConfig


PAPER_EMBED = EmbedConfig(
    method="huge",
    info_termination=True,
    mu=0.995,
    delta=1e-3,
    dim=128,
    window=10,
    negatives=5,
    multi_windows=2,
    lr=0.025,
    epochs=1,
)

@dataclasses.dataclass(frozen=True)
class GraphPreset:
    name: str
    num_nodes: int
    avg_degree: int


# R-MAT stand-ins scaled after Table 2 (|V|, avg deg = 2|E|/|V|).
GRAPH_PRESETS: Dict[str, GraphPreset] = {
    "fl-sim": GraphPreset("fl-sim", 80_513, 146),
    "yt-sim": GraphPreset("yt-sim", 1_138_499, 5),
    "lj-sim": GraphPreset("lj-sim", 2_238_731, 13),
    "or-sim": GraphPreset("or-sim", 3_072_441, 76),
    "tw-sim": GraphPreset("tw-sim", 41_652_230, 70),
    # CPU-feasible smoke presets
    "small": GraphPreset("small", 2_000, 10),
    "medium": GraphPreset("medium", 50_000, 10),
}
