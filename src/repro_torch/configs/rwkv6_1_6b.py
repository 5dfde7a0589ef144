"""RWKV6-1.6B "Finch" [arXiv:2404.05892]: attention-free, data-dependent
decay, O(1)-state decode.  Copied from ``repro.configs.rwkv6_1_6b``."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,                 # head_size 64
        n_kv_heads=32,
        d_ff=7168,
        vocab=65536,
        attn="none",
        skip_shapes=(),             # sub-quadratic: all four cells run
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        attn="none",
        skip_shapes=(),
    )
