"""yi-6b — llama-architecture dense GQA LM [arXiv:2403.04652; hf:01-ai/Yi-6B].

32L  d_model=4096  32H (GQA kv=4)  d_ff=11008  vocab=64000, head_dim=128,
rope_theta=5e6 (Yi's long-base RoPE). The same numbers as the JAX
package's ``configs/yi_6b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5.0e6,
    dtype="bfloat16",
    remat="full",
)
