"""Model configuration: a copy of the JAX package's ``models/config.py``.

One frozen dataclass covers every family the reference supports; per-family
fields default off, and configurations read the same in both packages
(``repro_torch.configs`` lists them). ``param_count`` is the reference's
analytic count: an encoder-decoder model's leaves out the decoder's
cross-attention norms and the two final norms. ``attn_impl`` and
``fsdp`` are read by the reference only: on the port the tensors' device
picks the attention route.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qk_norm: bool = False

    # --- MLA (multi-head latent attention) ---------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0           # 0 -> direct q projection
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ----------------------------------------------------------------
    moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0      # shared expert width = n_shared * moe_d_ff
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0    # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    moe_dispatch_groups: int = 1   # per-group (per-data-shard) capacity
                                   # dispatch: local scatter + A2A instead of
                                   # a global scatter-add (§Perf qwen2-moe)

    # --- SSM / hybrid / xLSTM ------------------------------------------------
    # block_cycle: repeating pattern of block kinds; num_layers total blocks.
    #   "a" attention+mlp, "m" mamba2, "x" mLSTM, "s" sLSTM
    block_cycle: Tuple[str, ...] = ("a",)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128           # SSD chunk length (memory/compute knob)

    # --- encoder-decoder ------------------------------------------------------
    encdec: bool = False
    enc_layers: int = 0
    dec_layers: int = 0

    # --- frontend stub ---------------------------------------------------------
    frontend: str = "none"         # none | audio | vision

    # --- misc -------------------------------------------------------------------
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"            # none | full — per-layer activation ckpt
    attn_impl: str = "ref"         # ref | flash (Pallas; TPU deploy path)
    fsdp: bool = False             # additionally shard params over data axis
    opt_state_dtype: str = "float32"   # bf16 moments for the 405B config
    grad_accum: int = 1            # microbatches per step (gradient accumulation)
    grad_accum_dtype: str = "float32"  # bf16 accumulators for the 405B config
    vocab_size_unpadded: int = 0   # informational: pre-TP-padding vocab size
    act_seq_shard: bool = True     # Megatron-SP residual sharding; False for
                                   # scan-dominated archs (reshard overhead)
    # long-context support: "none" = quadratic attention only (skip
    # long_500k per shape rules); "state" = SSM/hybrid state-based decode.
    long_context: str = "none"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def layer_cycles(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(cycle, n_full_cycles, remainder_pattern) covering num_layers."""
        cyc = self.block_cycle
        n = self.num_layers // len(cyc)
        rem = self.num_layers - n * len(cyc)
        return cyc, n, tuple(cyc[:rem])

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.use_mla:
                q_in = self.q_lora_rank or d
                qp = (d * self.q_lora_rank if self.q_lora_rank else 0) + (
                    q_in * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                )
                kvp = d * (self.kv_lora_rank + self.qk_rope_dim)
                kvp += self.kv_lora_rank * self.num_heads * (
                    self.qk_nope_dim + self.v_head_dim
                )
                op = self.num_heads * self.v_head_dim * d
                return qp + kvp + op
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def mlp_params() -> int:
            return 3 * d * self.d_ff  # SwiGLU: gate, up, down

        def moe_params() -> int:
            routed = self.n_routed_experts * 3 * d * self.moe_d_ff
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            router = d * self.n_routed_experts
            return routed + shared + router

        def mamba_params() -> int:
            d_in = self.ssm_expand * d
            nh = self.ssm_heads or (d_in // max(self.ssm_head_dim, 1))
            proj_in = d * (2 * d_in + 2 * self.ssm_state + nh)
            conv = self.ssm_conv * (d_in + 2 * self.ssm_state)
            proj_out = d_in * d
            return proj_in + conv + proj_out + nh

        def xlstm_params(kind: str) -> int:
            d_in = self.ssm_expand * d
            if kind == "x":  # mLSTM: q,k,v + gates + out
                return d * 3 * d_in + d * 2 * (self.ssm_heads or 4) + d_in * d + d * d_in
            return 4 * d * d + 4 * d * d + 2 * d  # sLSTM: in + recurrent gates

        total = emb
        cyc, n_cyc, rem = self.layer_cycles
        seq = list(cyc) * n_cyc + list(rem)
        if self.encdec:
            seq = ["a"] * (self.enc_layers + self.dec_layers)
        for kind in seq:
            if kind == "a":
                blk = attn_params() + (
                    moe_params() if self.moe else mlp_params()
                )
            elif kind == "m":
                blk = mamba_params()
            elif kind == "x":
                blk = xlstm_params("x")
            elif kind == "s":
                blk = xlstm_params("s")
            else:
                raise ValueError(kind)
            total += blk + 2 * d  # two RMSNorm scales
        if self.encdec:
            total += self.dec_layers * attn_params()  # cross-attention
        if self.moe and self.first_dense_layers:
            total += self.first_dense_layers * (mlp_params() - moe_params())
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        routed_all = self.num_moe_layers * self.n_routed_experts * 3 * self.d_model * self.moe_d_ff
        routed_active = self.num_moe_layers * self.top_k * 3 * self.d_model * self.moe_d_ff
        return full - routed_all + routed_active

    @property
    def num_moe_layers(self) -> int:
        if not self.moe:
            return 0
        return self.num_layers - self.first_dense_layers


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the evaluation grid."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
