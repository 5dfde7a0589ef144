"""Yi-6B [arXiv:2403.04652]: llama-arch with aggressive GQA (kv=4).

Copied from ``repro.configs.yi_6b``."""
from .base import ModelConfig

_FULL_ATTN_SKIP = ("long_500k",)


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab=64000,
        rope_theta=5_000_000.0,
        skip_shapes=_FULL_ATTN_SKIP,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        skip_shapes=_FULL_ATTN_SKIP,
    )
