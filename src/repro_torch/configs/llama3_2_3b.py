"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B]: small llama3, GQA kv=8.

Copied from ``repro.configs.llama3_2_3b``."""
from .base import ModelConfig

_FULL_ATTN_SKIP = ("long_500k",)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab=128256,
        tie_embeddings=True,
        rope_theta=500_000.0,
        skip_shapes=_FULL_ATTN_SKIP,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        tie_embeddings=True,
        skip_shapes=_FULL_ATTN_SKIP,
    )
