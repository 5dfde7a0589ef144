"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense decoder with MLA.

Copied from ``repro.configs.minicpm3_4b``."""
from .base import ModelConfig

_FULL_ATTN_SKIP = ("long_500k",)


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab=73448,
        attn="mla",
        kv_lora=256,
        q_lora=768,
        qk_nope=64,
        qk_rope=32,
        v_head=64,
        head_dim=96,                # qk_nope + qk_rope
        rope_theta=10_000.0,
        attn_seq_shard=True,        # 40 heads do not divide the 16-way axis
        skip_shapes=_FULL_ATTN_SKIP,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        attn="mla",
        kv_lora=32,
        q_lora=48,
        qk_nope=16,
        qk_rope=8,
        v_head=16,
        head_dim=24,
        skip_shapes=_FULL_ATTN_SKIP,
    )
