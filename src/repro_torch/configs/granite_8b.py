"""Granite-8B-Code [arXiv:2405.04324]: llama-arch GQA, tied embeddings.

Copied from ``repro.configs.granite_8b``."""
from .base import ModelConfig

_FULL_ATTN_SKIP = ("long_500k",)


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=49152,
        tie_embeddings=True,
        rope_theta=10_000.0,
        skip_shapes=_FULL_ATTN_SKIP,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
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
