"""Hymba-1.5B [arXiv:2411.13676]: hybrid -- parallel attention + Mamba heads
in every layer; sliding-window attention except first/middle/last layers.
Sub-quadratic => runs the long_500k cell.  Copied from
``repro.configs.hymba_1_5b``."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        head_dim=64,
        ssm_state=16,
        swa_window=1024,
        rope_theta=10_000.0,
        attn_seq_shard=True,        # 25 heads do not divide the 16-way axis
        skip_shapes=(),             # sub-quadratic: all four cells run
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        ssm_state=4,
        swa_window=8,
        skip_shapes=(),
    )
