"""llama3-405b — frontier-scale dense GQA LM [arXiv:2407.21783].

126L  d_model=16384  128H (GQA kv=8)  d_ff=53248  vocab=128256,
head_dim=128, rope_theta=5e5; full activation remat, bf16 optimizer
moments and gradient accumulators. Its bf16 weights alone are ~810 GB, so
one card runs it only at a cut depth. The same numbers as the JAX
package's ``configs/llama3_405b.py`` (``fsdp`` and ``grad_accum`` are read
by the reference only).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5.0e5,
    dtype="bfloat16",
    remat="full",
    fsdp=True,
    opt_state_dtype="bfloat16",
    grad_accum=8,
    grad_accum_dtype="bfloat16",
)
