"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434;
hf:deepseek-ai/DeepSeek-V2-Lite].

27L  d_model=2048  16H  vocab=102400.  MLA: kv_lora_rank=512,
qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, no q
compression (q_lora_rank=0 in the Lite model): prefill attends with one
KV head of dim 512 + 64 = 576. MoE: 64 routed + 2 shared experts, top-6,
moe_d_ff=1408. The same numbers as the JAX package's
``configs/deepseek_v2_lite_16b.py``. As there, ``first_dense_layers`` and
``d_ff`` enter only ``param_count``: the forward pass gives every layer
an MoE FFN, so the model holds 16,210,324,992 parameters.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,             # the single leading dense layer's width
    vocab_size=102400,
    use_mla=True,
    q_lora_rank=0,          # Lite: direct q projection
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe=True,
    n_routed_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=1.0e4,
    dtype="bfloat16",
    remat="full",
    fsdp=True,
)
