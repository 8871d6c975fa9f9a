"""Unified model configuration covering every assigned architecture family.

One frozen dataclass describes dense / GQA / MLA / MoE / Mamba / RWKV6 /
hybrid / encoder-decoder models.  Per-architecture instances live in
``repro/configs/<id>.py``; reduced smoke variants are derived with
``ModelConfig.reduced()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Block kinds a layer may take.
ATTN = "attn"
MAMBA = "mamba"
RWKV = "rwkv"

VALID_BLOCKS = (ATTN, MAMBA, RWKV)


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str = "model"
    arch_type: str = "dense"          # dense|moe|hybrid|ssm|vlm|audio
    source: str = ""                  # citation (paper / model card)

    # -- trunk -------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2                # query heads (0 for attention-free)
    num_kv_heads: int = 2
    head_dim: int = 0                 # 0 -> d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 256
    max_seq_len: int = 8192
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu|gelu
    ffn_kind: str = "swiglu"          # swiglu (3-matrix) | mlp (2-matrix, granite/whisper)

    # -- attention flavour --------------------------------------------------
    attention_kind: str = "gqa"       # gqa|mla
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen1.5
    rope_theta: float = 1_000_000.0
    pos_embed: str = "rope"           # rope|learned (whisper decoder)
    sliding_window: int = 0           # 0 = full attention; >0 = SWA (mixtral)
    attn_impl: str = "naive"          # naive (materialised scores) | blocked (online-softmax XLA flash)
    decode_impl: str = "auto"         # T==1 decode attention: auto (pallas on TPU;
                                      # naive for tiny caches, length-bounded blocked
                                      # beyond) | naive | blocked | pallas | interpret

    # -- KV cache layout (DESIGN.md §13) -------------------------------------
    cache_layout: str = "dense"       # dense (contiguous (B, S) slabs) | paged
                                      # (block-table pools, CoW prompt sharing)
    kv_block_size: int = 32           # paged: KV slots per physical block

    # -- MLA (deepseek-v3) ---------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0              # 0 = dense FFN everywhere
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0       # deepseek-v3: 1 shared expert
    moe_d_ff: int = 0                 # expert hidden dim (defaults to d_ff)
    first_dense_layers: int = 0       # deepseek-v3: first 3 layers dense FFN
    moe_every: int = 1                # jamba: MoE on every 2nd layer
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-4
    moe_impl: str = "dense"           # dense (exact) | dispatch (GShard einsum) | sort (argsort gather/scatter)
    moe_groups: int = 0               # dispatch groups (0 = one per sequence)

    # -- hybrid / SSM layout -------------------------------------------------
    block_kind: str = ATTN            # default block type for all layers
    attn_period: int = 0              # jamba: attention once per `period` layers
    attn_offset: int = 0              # position of the attn layer in the period

    # -- mamba ---------------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0            # 0 -> ceil(d_model/16)
    scan_chunk: int = 64              # recurrent-scan remat chunk (mamba/rwkv)

    # -- rwkv6 ---------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 32

    # -- encoder-decoder (whisper) --------------------------------------------
    encoder_layers: int = 0
    encoder_frames: int = 0           # stubbed frontend output length
    cross_attention: bool = False

    # -- modality frontend stub ------------------------------------------------
    frontend: str = ""                # ''|'audio'|'vision'
    num_prefix_embeddings: int = 0    # vision patch embeddings prepended

    # -- extras ----------------------------------------------------------------
    tie_embeddings: bool = False
    mtp: bool = False                 # deepseek-v3 multi-token prediction head
    logit_softcap: float = 0.0

    # -- numerics ----------------------------------------------------------------
    dtype: str = "float32"            # activation dtype
    param_dtype: str = "float32"
    remat: str = "none"               # none|full|dots  (activation ckpt policy)

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def block_kind_for_layer(self, i: int) -> str:
        """Which block type layer ``i`` uses (jamba interleave etc.)."""
        if self.attn_period > 0:
            return ATTN if (i % self.attn_period) == self.attn_offset else self.block_kind
        return self.block_kind

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts <= 0:
            return False
        if i < self.first_dense_layers:
            return False
        return ((i - self.first_dense_layers) % self.moe_every) == 0

    def layer_plan(self) -> Tuple[Tuple[str, bool], ...]:
        """Per-layer (block_kind, is_moe) tuples for the decoder trunk."""
        return tuple(
            (self.block_kind_for_layer(i), self.is_moe_layer(i))
            for i in range(self.num_layers)
        )

    @property
    def has_decode_path(self) -> bool:
        return True  # all assigned archs have a decoder

    @property
    def subquadratic(self) -> bool:
        """True when a 500k-token decode is feasible (SSM / hybrid / SWA)."""
        plan = self.layer_plan()
        for kind, _ in plan:
            if kind == ATTN and self.sliding_window == 0 and self.attn_period == 0:
                return False
        # hybrids with a few full-attention layers qualify (KV is seq-sharded)
        return True

    def validate(self) -> None:
        assert self.block_kind in VALID_BLOCKS, self.block_kind
        assert self.decode_impl in ("auto", "naive", "blocked", "pallas",
                                    "interpret"), self.decode_impl
        assert self.cache_layout in ("dense", "paged"), self.cache_layout
        assert self.kv_block_size > 0, self.kv_block_size
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                f"{self.name}: num_heads {self.num_heads} not divisible by "
                f"kv heads {self.num_kv_heads}")
        if self.attention_kind == "mla":
            assert self.kv_lora_rank > 0 and self.qk_rope_head_dim > 0
        if self.num_experts:
            assert 0 < self.num_experts_per_tok <= self.num_experts
        if self.cross_attention:
            assert self.encoder_layers > 0

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant of the same family: tiny but shape-faithful."""
        changes = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=min(self.max_seq_len, 256),
            dtype="float32", param_dtype="float32",
            moe_impl="dense", remat="none",
        )
        if self.num_heads:
            heads = min(self.num_heads, 4)
            kv = min(self.num_kv_heads, heads)
            while heads % kv:
                kv -= 1
            changes.update(num_heads=heads, num_kv_heads=kv, head_dim=0)
        changes["d_ff"] = min(self.d_ff, 512)
        if self.num_experts:
            e = min(self.num_experts, 4)
            changes.update(
                num_experts=e,
                num_experts_per_tok=min(self.num_experts_per_tok, 2, e),
                moe_d_ff=min(self.resolved_moe_d_ff, 256),
                first_dense_layers=min(self.first_dense_layers, 1),
            )
        if self.attention_kind == "mla":
            changes.update(
                q_lora_rank=min(self.q_lora_rank, 64) or 0,
                kv_lora_rank=min(self.kv_lora_rank, 64),
                qk_nope_head_dim=min(self.qk_nope_head_dim, 32),
                qk_rope_head_dim=min(self.qk_rope_head_dim, 16),
                v_head_dim=min(self.v_head_dim, 32),
            )
        if self.block_kind == RWKV or self.arch_type == "ssm":
            changes["rwkv_head_dim"] = min(self.rwkv_head_dim, 32)
            changes["d_model"] = 128  # divisible by rwkv head dim
        if self.attn_period:
            changes["num_layers"] = self.attn_period  # keep one full period
            changes["attn_offset"] = min(self.attn_offset, self.attn_period - 1)
        if self.encoder_layers:
            changes.update(encoder_layers=min(self.encoder_layers, 2),
                           encoder_frames=min(self.encoder_frames or 64, 64))
        if self.sliding_window:
            changes["sliding_window"] = min(self.sliding_window, 64)
        if self.num_prefix_embeddings:
            changes["num_prefix_embeddings"] = min(self.num_prefix_embeddings, 16)
        changes.update(overrides)
        cfg = dataclasses.replace(self, **changes)
        cfg.validate()
        return cfg

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
