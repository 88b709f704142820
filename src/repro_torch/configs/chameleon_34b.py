"""chameleon-34b — early-fusion VLM backbone [arXiv:2405.09818].

48L  d_model=8192  64H (GQA kv=8)  d_ff=22016  vocab=65536 (text + VQ image
codes in one vocabulary: early fusion means images are just tokens).
Chameleon's training-stability recipe includes qk-norm, kept here.

Frontend stub: the VQ-GAN tokenizer is out of scope;
``repro_torch.models.frontend.vq_token_stream`` emits interleaved
text + image-code ids, and the model's inputs are ordinary (B, S) token
ids. The same numbers as the JAX package's ``configs/chameleon_34b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    frontend="vision",
    rope_theta=1.0e4,
    dtype="bfloat16",
    remat="full",
    fsdp=True,
    grad_accum=4,
)
