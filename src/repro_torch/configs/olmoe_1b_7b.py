"""OLMoE-1B-7B [arXiv:2409.02060]: 64-expert top-8 MoE, 1B active / 7B total.

The PRIMARY arch for the paper's technique: token->expert routing skew is
partitioning skew verbatim.  Copied from ``repro.configs.olmoe_1b_7b``."""
from .base import ModelConfig

_FULL_ATTN_SKIP = ("long_500k",)   # pure full attention: 524k decode skipped


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,                  # per-expert FFN width
        vocab=50304,
        n_experts=64,
        top_k=8,
        d_expert=1024,
        rope_theta=10_000.0,
        skip_shapes=_FULL_ATTN_SKIP,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab=256,
        n_experts=8,
        top_k=2,
        d_expert=32,
        skip_shapes=_FULL_ATTN_SKIP,
    )
