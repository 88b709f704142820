"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large].

24 encoder + 24 decoder layers, d_model=1024, 16H (kv=16), d_ff=8192,
vocab=256206 (padded to 256208). The audio frontend (w2v-BERT conformer
stem) is a stub: the encoder takes precomputed (B, S_src, 1024) frame
embeddings (``repro_torch.models.frontend.audio_frames``).

Shape semantics (``models/zoo.py``): a training batch of ``seq_len``
splits it as S_src = S_tgt = seq_len // 2; a serving cell holds a
4096-frame encoder memory (``zoo.CROSS_SRC_LEN``). The same numbers as the
JAX package's ``configs/seamless_m4t_large_v2.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=48,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256208,         # 256206 padded to a multiple of 16 for TP
    vocab_size_unpadded=256206,
    encdec=True,
    enc_layers=24,
    dec_layers=24,
    frontend="audio",
    rope_theta=1.0e4,
    dtype="bfloat16",
    remat="full",
)
