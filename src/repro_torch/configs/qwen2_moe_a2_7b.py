"""qwen2-moe-a2.7b — fine-grained MoE, 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24L  d_model=2048  16H (kv=16)  vocab=151936.  moe_d_ff=1408 per routed
expert, the 60 experts held in 64 slots (padded to a multiple of 16); the
shared expert is ONE MLP of width 4x1408=5632 (HF
shared_expert_intermediate_size), running on every token. The same
numbers as the JAX package's ``configs/qwen2_moe_a2_7b.py``: with the
padding the model holds 15,146,059,776 parameters.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,              # dense width (unused: all layers are MoE)
    vocab_size=151936,
    moe=True,
    n_routed_experts=60,
    n_shared_experts=4,     # -> one shared MLP of width 4 * moe_d_ff
    top_k=4,
    moe_d_ff=1408,
    first_dense_layers=0,
    rope_theta=1.0e6,
    dtype="bfloat16",
    remat="full",
    fsdp=True,
)
