"""minicpm3-4b — dense LM with multi-head latent attention (MLA)
[hf:openbmb/MiniCPM3-4B].

62L  d_model=2560  40H  d_ff=6400  vocab=73448 (73456 padded). MLA dims
from the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64: every head
derives its keys and values from one shared 256-wide latent, so prefill
attends with one KV head of dim 256 + 32 = 288. The same numbers as the
JAX package's ``configs/minicpm3_4b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73456,          # 73448 padded to a multiple of 16 for TP
    vocab_size_unpadded=73448,
    use_mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    rope_theta=1.0e4,
    dtype="bfloat16",
    remat="full",
    tie_embeddings=True,
)
