"""xlstm-350m — sLSTM + mLSTM recurrent LM [arXiv:2405.04517].

24 blocks  d_model=1024  4 heads  vocab=50304, d_ff=0 (the xLSTM blocks
carry their own up and down projections; there is no separate FFN). The
block cycle is the paper's xLSTM[7:1] ratio: seven mLSTM blocks ("x"),
then one sLSTM block ("s"), three times. The same numbers as the JAX
package's ``configs/xlstm_350m.py``: each mLSTM head keeps a 512 x 513
matrix memory (head dim 512 plus the normaliser column), scanned in chunks
of 512 steps.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_cycle=("x", "x", "x", "x", "x", "x", "x", "s"),
    ssm_heads=4,
    ssm_expand=2,
    ssm_chunk=512,
    dtype="bfloat16",
    remat="full",
    long_context="state",
    tie_embeddings=True,
    act_seq_shard=False,
)
