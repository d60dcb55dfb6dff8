"""Qwen2-57B-A14B [HAP Table III row 3] — 57.4B params, 64 routed experts
top-8 + shared expert, d_ff=2560."""
from .base import ModelConfig, register


@register("qwen2-57b-a14b")
def qwen2_57b_a14b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-57b-a14b",
        family="moe",
        source="HAP Table III / arXiv:2407.10671",
        num_layers=28,
        d_model=3584,
        vocab_size=151936,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=2560,
        ffn_type="moe",
        n_routed_experts=64,
        n_shared_experts=1,
        top_k=8,
        moe_d_ff=2560,
        shared_d_ff=20480,
        activation="silu",
        rope_theta=1000000.0,
    )
