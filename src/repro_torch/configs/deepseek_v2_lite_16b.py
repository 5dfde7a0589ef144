"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: MLA + fine-grained MoE.

MLA: kv compressed to a 512-dim latent (the cache stores the latent only);
MoE: 64 routed experts top-6 + 2 shared, first layer dense (d_ff 10944).
The assignment line lists both "64e" and "160 routed"; 64 routed matches
the published V2-Lite (160 is full V2) — recorded in DESIGN.md.

Copied from ``repro.configs.deepseek_v2_lite_16b``."""
from .base import ModelConfig

_FULL_ATTN_SKIP = ("long_500k",)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,                 # the single dense layer's FFN
        vocab=102400,
        attn="mla",
        kv_lora=512,
        qk_nope=128,
        qk_rope=64,
        v_head=128,
        head_dim=192,               # qk_nope + qk_rope
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        d_shared=2816,              # 2 shared experts x 1408
        first_k_dense=1,
        rope_theta=10_000.0,
        skip_shapes=_FULL_ATTN_SKIP,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        attn="mla",
        kv_lora=32,
        qk_nope=16,
        qk_rope=8,
        v_head=16,
        head_dim=24,
        n_experts=8,
        top_k=2,
        d_expert=32,
        n_shared=2,
        d_shared=64,
        first_k_dense=1,
        skip_shapes=_FULL_ATTN_SKIP,
    )
