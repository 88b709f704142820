"""qwen3-1.7b — dense GQA with per-head qk RMS-norm [hf:Qwen/Qwen3-1.7B].

28L  d_model=2048  16H (GQA kv=8)  d_ff=6144  vocab=151936, head_dim=128,
qk_norm (the Qwen3-family signature), rope_theta=1e6. The same numbers as
the JAX package's ``configs/qwen3_1_7b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1.0e6,
    dtype="bfloat16",
    remat="full",
    tie_embeddings=True,   # Qwen3 <8B ties lm_head to the embedding
)
