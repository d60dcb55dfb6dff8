"""Qwen1.5-MoE-A2.7B [HAP Table III row 2] — 14.3B params, 60 routed
experts top-4 + 4 shared experts, fine-grained d_ff=1408."""
from .base import ModelConfig, register


@register("qwen1.5-moe-a2.7b")
def qwen15_moe_a2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-moe-a2.7b",
        family="moe",
        source="HAP Table III / Qwen1.5-MoE blog",
        num_layers=24,
        d_model=2048,
        vocab_size=151936,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        ffn_type="moe",
        n_routed_experts=60,
        n_shared_experts=1,          # one shared expert of 4x width (5632)
        top_k=4,
        moe_d_ff=1408,
        shared_d_ff=5632,
        activation="silu",
        rope_theta=1000000.0,
    )
