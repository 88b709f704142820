"""Partition specs of the models' parameter and cache trees: the JAX
package's ``spec_*`` functions (``models/layers.py``, ``attention.py``,
``mla.py``, ``moe.py``, ``mamba2.py``, ``xlstm.py``, ``transformer.py``,
``encdec.py``), in the port's spec type and its tree layout.

The port keeps a layer group (and an encoder-decoder's ``enc`` and
``dec`` stacks) as a list of per-repetition dicts, where the reference
stacks the repetitions on a leading axis and prepends an unsharded entry
to every spec (``P(None, *s)``). Here each repetition's leaves get the
block's spec as it is, so a spec tree mirrors its parameter (or cache)
tree leaf for leaf. With ``cfg.fsdp`` the weights' contraction dims also
shard over "data", as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.dist.sharding import BATCH_AXES, PRODUCTION_MODEL_AXIS, P
from repro_torch.models.config import ModelConfig

Specs = Dict[str, Any]


def _dax(cfg: ModelConfig):
    return "data" if cfg.fsdp else None


def rmsnorm() -> Specs:
    return {"scale": P(None)}


def mlp(fsdp: bool) -> Specs:
    dax = "data" if fsdp else None
    return {"gate": P(dax, "model"), "up": P(dax, "model"), "down": P("model", dax)}


def embedding(tie: bool, fsdp: bool) -> Specs:
    dax = "data" if fsdp else None
    p = {"table": P("model", dax)}            # vocab-sharded over "model"
    if not tie:
        p["head"] = P(dax, "model")
    return p


def attention(cfg: ModelConfig) -> Specs:
    dax = _dax(cfg)
    p = {"wq": P(dax, "model", None), "wk": P(dax, "model", None),
         "wv": P(dax, "model", None), "wo": P("model", None, dax)}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": P(None)}
        p["k_norm"] = {"scale": P(None)}
    return p


def kv_cache(cfg: ModelConfig = None) -> Specs:
    """Heads over "model" when the KV-head count divides the production
    tensor axis, else the sequence (split-KV), as the reference lays the
    cache out."""
    if cfg is None or cfg.num_kv_heads % PRODUCTION_MODEL_AXIS == 0:
        s = P(BATCH_AXES, "model", None, None)
    else:
        s = P(BATCH_AXES, None, "model", None)
    return {"k": s, "v": s}


def mla(cfg: ModelConfig) -> Specs:
    dax = _dax(cfg)
    p: Specs = {}
    if cfg.q_lora_rank:
        p["wq_down"] = P(dax, None)
        p["q_norm"] = {"scale": P(None)}
        p["wq_up"] = P(dax, "model", None)
    else:
        p["wq"] = P(dax, "model", None)
    p.update(wkv_down=P(dax, None), kv_norm={"scale": P(None)}, wk_rope=P(dax, None),
             wk_up=P(None, "model", None), wv_up=P(None, "model", None),
             wo=P("model", None, dax))
    return p


def mla_cache() -> Specs:
    return {"ckv": P(BATCH_AXES, None, None), "krope": P(BATCH_AXES, None, None)}


def moe(cfg: ModelConfig) -> Specs:
    dax = _dax(cfg)
    p: Specs = {"router": P(None, None), "gate": P("model", dax, None),   # experts over "model"
                "up": P("model", dax, None), "down": P("model", dax, None)}
    if cfg.n_shared_experts:
        p["shared"] = {"gate": P(dax, "model"), "up": P(dax, "model"), "down": P("model", dax)}
    return p


def mamba(cfg: ModelConfig) -> Specs:
    dax = _dax(cfg)
    return {"in_proj": P(dax, "model"), "conv_w": P(None, "model"), "conv_b": P("model"),
            "A_log": P(None), "D": P(None), "dt_bias": P(None), "norm": {"scale": P("model")},
            "out_proj": P("model", dax)}


def mamba_state() -> Specs:
    return {"conv": P(BATCH_AXES, None, "model"), "ssm": P(BATCH_AXES, "model", None, None)}


def mlstm(cfg: ModelConfig) -> Specs:
    dax = _dax(cfg)
    return {"wq": P(dax, "model"), "wk": P(dax, "model"), "wv": P(dax, "model"),
            "wi": P(None, "model"), "wf": P(None, "model"), "wo_gate": P(dax, "model"),
            "norm": {"scale": P("model")}, "out_proj": P("model", dax)}


def mlstm_state() -> P:
    return P(BATCH_AXES, "model", None, None)


def slstm(cfg: ModelConfig) -> Specs:
    """Replicated over "model": the cell is a strict time recurrence (the
    reference's reason: any model-sharding of d is one all-reduce a step)."""
    return {"w": P(_dax(cfg), None), "r": P(None, None), "b": P(None)}


def slstm_state() -> Specs:
    s = P(BATCH_AXES, "model")
    return {"c": s, "n": s, "h": s}


def block(kind: str, cfg: ModelConfig) -> Specs:
    if kind == "a":
        return {"ln1": rmsnorm(), "attn": mla(cfg) if cfg.use_mla else attention(cfg),
                "ln2": rmsnorm(), "ffn": moe(cfg) if cfg.moe else mlp(cfg.fsdp)}
    if kind == "m":
        return {"ln": rmsnorm(), "mixer": mamba(cfg)}
    if kind == "x":
        p = {"ln": rmsnorm(), "mixer": mlstm(cfg)}
        if cfg.d_ff:
            p.update(ln2=rmsnorm(), ffn=mlp(cfg.fsdp))
        return p
    if kind == "s":
        return {"ln": rmsnorm(), "mixer": slstm(cfg)}
    raise ValueError(kind)


def block_cache(kind: str, cfg: ModelConfig):
    if kind == "a":
        return mla_cache() if cfg.use_mla else kv_cache(cfg)
    if kind == "m":
        return mamba_state()
    if kind == "x":
        return mlstm_state()
    if kind == "s":
        return slstm_state()
    raise ValueError(kind)


def enc_block(cfg: ModelConfig) -> Specs:
    return {"ln1": rmsnorm(), "attn": attention(cfg), "ln2": rmsnorm(), "ffn": mlp(cfg.fsdp)}


def dec_block(cfg: ModelConfig) -> Specs:
    return {"ln1": rmsnorm(), "self_attn": attention(cfg), "ln_x": rmsnorm(),
            "cross_attn": attention(cfg), "ln2": rmsnorm(), "ffn": mlp(cfg.fsdp)}
