"""Whisper-medium [arXiv:2212.04356]: encoder-decoder audio backbone.

The conv frontend is a stub: precomputed frame embeddings [B, 1500,
d_model] (``batch["frames"]``; the serve engine and the train launcher
pass zeros); the encoder is 24 layers of bidirectional attention, the
decoder 24 layers with cross-attention.  Learned encoder positions and
RoPE on the decoder stand in for Whisper's sinusoidal and learned absolute
embeddings, as in the JAX package.  Copied from
``repro.configs.whisper_medium``."""
from .base import ModelConfig

_FULL_ATTN_SKIP = ("long_500k",)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,                # decoder layers
        n_enc_layers=24,
        enc_seq=1500,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=51865,
        norm="ln",
        act="gelu",
        skip_shapes=_FULL_ATTN_SKIP,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        enc_seq=12,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        norm="ln",
        act="gelu",
        skip_shapes=_FULL_ATTN_SKIP,
    )
