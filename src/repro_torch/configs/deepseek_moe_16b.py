"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained MoE:
64 routed experts (top-6) + 2 shared experts, 28 layers."""
from .base import ModelConfig, register


@register("deepseek-moe-16b")
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        source="arXiv:2401.06066",
        num_layers=28,
        d_model=2048,
        vocab_size=102400,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        ffn_type="moe",
        n_routed_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        shared_d_ff=1408,
        activation="silu",
        rope_theta=10000.0,
    )
