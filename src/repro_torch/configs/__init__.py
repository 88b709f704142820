"""Architecture registry of the port: the configurations it runs.

``get_config(name)`` returns the full published config, ``get_reduced(name)``
the CPU-test version (same family, tiny dims), with the JAX package's names
and aliases. The port runs every architecture of the reference: the dense
decoder-only ``qwen3-1.7b``, ``yi-6b`` and ``llama3-405b``, the Mamba2 +
attention hybrid ``zamba2-7b``, the mLSTM + sLSTM recurrent ``xlstm-350m``, the
multi-head latent attention model ``minicpm3-4b``, the mixtures of
experts ``qwen2-moe-a2.7b`` and ``deepseek-v2-lite-16b`` (MLA + MoE), the
encoder-decoder ``seamless-m4t-large-v2`` (audio frames in) and the
early-fusion ``chameleon-34b`` (VQ image codes as tokens).
``distger`` holds the embedding system's own presets.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["qwen3_1_7b", "zamba2_7b", "xlstm_350m", "minicpm3_4b",
                       "deepseek_v2_lite_16b", "qwen2_moe_a2_7b", "yi_6b", "llama3_405b",
                       "seamless_m4t_large_v2", "chameleon_34b"]

# canonical external ids (grid spelling) -> module names, as in the reference
ALIASES: Dict[str, str] = {
    "yi-6b": "yi_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "minicpm3-4b": "minicpm3_4b",
    "llama3-405b": "llama3_405b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "chameleon-34b": "chameleon_34b",
    "xlstm-350m": "xlstm_350m",
}


def normalize(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    arch = normalize(name)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}: the port runs {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def get_reduced(name: str) -> ModelConfig:
    from repro_torch.models.zoo import reduce_config
    return reduce_config(get_config(name))
