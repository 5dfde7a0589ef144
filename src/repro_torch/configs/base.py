"""Model configuration for the assigned architectures.

A copy of ``repro.configs.base.ModelConfig``: the same fields and defaults,
so a configuration built by either package describes the same model.  The
JAX package's dry-run shapes (``SHAPES``, ``input_specs``) are not ported;
``skip_shapes`` stays a field so the copied configurations stay verbatim.
:func:`dtype_of` maps the dtype names to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm: str = "rms"               # rms | ln
    act: str = "swiglu"             # swiglu | gelu
    attn: str = "gqa"               # gqa | mla | none
    tie_embeddings: bool = False

    # --- MLA ---
    kv_lora: int = 0
    q_lora: Optional[int] = None
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared: int = 0
    d_shared: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # Spare physical expert slots for the Reshape balancer's SBR
    # replication (0 = plain MoE; SBK slot-swaps need no spares).
    moe_replica_slots: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    swa_window: int = 0             # sliding-window size (hybrid)

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                # stubbed frame embeddings length

    # --- VLM (internvl) ---
    n_patches: int = 0              # stubbed patch embeddings prepended

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # Sequence-parallel attention: shard the query/seq dim of the flash
    # score blocks over "model" — used when the head count does not divide
    # the model axis (minicpm3 40H, hymba 25H on a 16-way axis), where
    # head sharding is unavailable and replicated scores would blow HBM.
    attn_seq_shard: bool = False

    # §Perf knobs (beyond-paper optimizations; 1/False = paper baseline).
    # moe_token_groups > 1 switches to DP-local MoE dispatch (per-group
    # capacity; groups pinned to the data axis) — kills the token
    # all-gather + expert-compute replication of the naive global dispatch.
    moe_token_groups: int = 1
    # Sequence-parallel residual stream: keep the scanned block carry
    # sharded [batch->data, seq->model] so remat-saved activations shard
    # over the model axis too (Megatron-SP style).
    seq_parallel_residual: bool = False
    # Decode-cache layout: shard the cache SEQ dim over "model" (scores
    # computed on local KV slices + tiny softmax-stat all-reduce) instead
    # of the head/latent dim (partial-sum all-reduce of full score rows).
    decode_cache_seq_shard: bool = False
    # Gradient accumulation: split the global batch into this many
    # microbatches (lax.scan) — divides activation memory by the factor.
    train_microbatch: int = 1

    # shapes this arch skips (with the reason recorded in DESIGN.md)
    skip_shapes: Tuple[str, ...] = ()

    # ------------------------------------------------------------------ #
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, L, V, ff = self.d_model, self.n_layers, self.vocab, self.d_ff
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.attn == "mla":
            q = d * (self.q_lora or 0) + (self.q_lora or d) * self.n_heads * (
                self.qk_nope + self.qk_rope) if self.q_lora else \
                d * self.n_heads * (self.qk_nope + self.qk_rope)
            kv = d * self.kv_lora + d * self.qk_rope + self.kv_lora * \
                self.n_heads * (self.qk_nope + self.v_head)
            o = self.n_heads * self.v_head * d
            attn = q + kv + o
        elif self.attn == "gqa":
            attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
                + self.n_heads * self.hd * d
        else:
            attn = 0
        if self.family == "ssm":
            mix = 4 * d * d + d * 64 + 64 * d + d * d      # rwkv time-mix
            cmix = 2 * d * ff
            per_layer = mix + cmix
        elif self.n_experts:
            moe = self.n_experts * 3 * d * self.d_expert + d * self.n_experts
            if self.n_shared:
                moe += 3 * d * (self.d_shared or self.d_expert * self.n_shared)
            dense_ff = 3 * d * ff
            per_layer = attn + (self.first_k_dense * dense_ff +
                                (L - self.first_k_dense) * moe) / L
        else:
            ffp = 3 * d * ff if self.act == "swiglu" else 2 * d * ff
            per_layer = attn + ffp
            if self.family == "hybrid":
                per_layer += 3 * d * d + d * (2 * self.ssm_state)  # mamba head
        total = emb + int(L * per_layer)
        if self.family == "encdec":
            enc_ff = 2 * d * ff
            enc_attn = 4 * d * d
            total += self.n_enc_layers * (enc_attn + enc_ff)
            total += int(L * (4 * d * d))   # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE): routed top_k + shared + attn."""
        if not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        all_experts = L * self.n_experts * 3 * d * self.d_expert
        active_experts = L * self.top_k * 3 * d * self.d_expert
        return int(full - all_experts + active_experts)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
