"""LM serving: prefill + decode over a pool of request slots.

The port of the JAX package's ``runtime/server.py``, with its semantics:
requests are served in waves of ``batch_slots`` (``wave_batches``); a
wave's prompts are left-padded with token 0 to the longest, with no pad
mask, and prefilled in one call; then every slot decodes greedily (argmax)
up to the wave's largest ``max_new_tokens``, and each request keeps its
own first ``max_new_tokens`` tokens. On the card a prefill runs the flash
kernel in every attention layer (in an MLA layer on the latent: one KV
head of dim kv_lora_rank + qk_rope_dim), the chunked SSD scan in every
Mamba2 layer and its wide route in every mLSTM layer; an sLSTM layer
steps its recurrence token by token. The recurrent states run over the
pad tokens, and an MoE layer routes them (they take expert capacity in
token order), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import zoo
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.serve import wave_batches


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    output: Optional[np.ndarray] = None


@dataclasses.dataclass
class ServerConfig:
    batch_slots: int = 4
    max_len: int = 256


class Server:
    """Single-model batched server (decoder-only archs) on ``device``.

    ``params`` are the model's weights (``zoo.init_params`` or a converted
    reference tree) on that device."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServerConfig, device="cuda"):
        if cfg.encdec:
            # as the reference's, which names an encoder-decoder server that
            # neither package has
            raise NotImplementedError(f"{cfg.name} is an encoder-decoder model: serve it "
                                      "through zoo.prefill_fn and zoo.decode_fn, whose "
                                      "batches carry the source frames")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self._prefill = zoo.prefill_fn(cfg, scfg.max_len)
        self._decode = zoo.decode_fn(cfg)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1)

    def serve(self, requests: List[Request]) -> List[Request]:
        """Process all requests, ``batch_slots`` at a time."""
        out: List[Request] = []
        for wave in wave_batches(list(requests), self.scfg.batch_slots):
            out.extend(self._serve_wave(wave))
        return out

    def _serve_wave(self, wave: List[Request]) -> List[Request]:
        b = len(wave)
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        logits, caches = self._prefill(
            self.params, {"tokens": torch.as_tensor(toks, device=self.device)})
        cache_len = plen
        cur = self._sample(logits)[:, None]
        budget = max(r.max_new_tokens for r in wave)
        gen = [cur]
        for _ in range(budget - 1):
            logits, caches = self._decode(self.params, caches, cur, cache_len)
            cache_len += 1
            cur = self._sample(logits)[:, None]
            gen.append(cur)
        g = torch.cat(gen, dim=1).cpu().numpy().astype(np.int32)
        for i, r in enumerate(wave):
            r.output = g[i, : r.max_new_tokens]
        return wave


def throughput_stats(n_tokens: int, seconds: float) -> Dict[str, float]:
    return {"tokens": n_tokens, "seconds": seconds,
            "tok_per_s": n_tokens / max(seconds, 1e-9)}
