"""Modality front-end stubs: the port of the JAX package's
``models/frontend.py``.

seamless-m4t's and chameleon's configurations specify the transformer
backbone only; the real front ends (a conformer audio encoder, a VQ-GAN
image tokenizer) are out of scope in both packages. Instead:

* audio: the encoder takes precomputed frame embeddings (B, S_src,
  d_model) in float32, what the conformer stem would emit
  (``audio_frames``).
* vision: chameleon is early-fusion: images arrive as discrete VQ codes
  inside its 65,536-entry vocabulary, so its inputs are ordinary token ids;
  ``vq_token_stream`` mimics a text + image interleave.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

# Chameleon reserves a contiguous block at the top of the vocabulary for
# image codes; the stub stream draws from it (8,192 VQ codes is the public
# codebook size).
VQ_CODEBOOK = 8192


def audio_frames(seed: int, batch: int, src_len: int, d_model: int,
                 device="cuda") -> torch.Tensor:
    """Stand-in for the conformer stem's output: unit-variance float32 frame
    embeddings (batch, src_len, d_model), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``. The reference draws them with
    ``jax.random.normal``, which ``repro_torch.prng`` has no bit-exact
    counterpart of: the distribution is the same, the bits are not."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(batch, src_len, d_model, generator=gen, dtype=torch.float32, device=dev)


def vq_token_stream(key: prng.Key, batch: int, seq: int, vocab: int,
                    image_frac: float = 0.5, device="cuda") -> torch.Tensor:
    """Interleaved text + image token ids (batch, seq), int64: the first
    ``image_frac`` of each row VQ codes drawn from the top-of-vocabulary
    code block, the rest text ids below it. Bit-equal to the reference's
    for the same key (``prng.split`` and ``prng.randint`` are
    ``jax.random``'s)."""
    dev = resolve_device(device)
    k1, k2 = prng.split(key)
    n_img = int(seq * image_frac)
    img = prng.randint(k1, (batch, n_img), vocab - VQ_CODEBOOK, vocab, dev)
    txt = prng.randint(k2, (batch, seq - n_img), 0, vocab - VQ_CODEBOOK, dev)
    return torch.cat([img, txt], dim=1).to(torch.int64)


def frontend_kind(cfg: ModelConfig) -> str:
    return cfg.frontend
