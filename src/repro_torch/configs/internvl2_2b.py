"""InternVL2-2B [arXiv:2404.16821]: InternViT stub + InternLM2-1.8B LM.

The vision tower is a stub: precomputed patch embeddings [B, 1024,
d_model] (``batch["patches"]``; the serve engine and the train launcher
pass zeros) are prepended to the text sequence; the LM backbone below is
InternLM2-1.8B (GQA kv=8).  Copied from ``repro.configs.internvl2_2b``."""
from .base import ModelConfig

_FULL_ATTN_SKIP = ("long_500k",)


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92553,
        n_patches=1024,
        rope_theta=1_000_000.0,
        skip_shapes=_FULL_ATTN_SKIP,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        n_patches=4,
        skip_shapes=_FULL_ATTN_SKIP,
    )
