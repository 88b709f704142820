"""zamba2-7b — hybrid Mamba2 + periodic attention blocks [arXiv:2411.15242].

81 blocks  d_model=3584  attn 32H (kv=32)  d_ff=14336  vocab=32000,
ssm_state=64. Block cycle: five Mamba2 mixers then one attention+MLP block
(13 attention positions over 81 blocks). The same numbers as the JAX
package's ``configs/zamba2_7b.py``, with its adaptation: Zamba2 re-uses one
shared attention block's weights at every attention position; each
attention position here has weights of its own (~0.6B more parameters).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_cycle=("m", "m", "m", "m", "m", "a"),
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,       # d_in = 7168 -> 112 SSD heads
    ssm_conv=4,
    rope_theta=1.0e4,
    dtype="bfloat16",
    remat="full",
    long_context="state",
    act_seq_shard=False,
)
