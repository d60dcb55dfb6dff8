"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE, 128 routed experts top-8
(no shared experts), fine-grained d_ff=768."""
from .base import ModelConfig, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe_30b_a3b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        num_layers=48,
        d_model=2048,
        vocab_size=151936,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        ffn_type="moe",
        n_routed_experts=128,
        n_shared_experts=0,
        top_k=8,
        moe_d_ff=768,
        activation="silu",
        rope_theta=1000000.0,
    )
