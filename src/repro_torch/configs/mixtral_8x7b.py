"""Mixtral-8x7B [arXiv:2401.04088] — the paper's primary evaluation model
(Table III row 1): 46.7B params, 8 experts top-2."""
from .base import ModelConfig, register


@register("mixtral-8x7b")
def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        source="arXiv:2401.04088 / HAP Table III",
        num_layers=32,
        d_model=4096,
        vocab_size=32000,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        ffn_type="moe",
        n_routed_experts=8,
        n_shared_experts=0,
        top_k=2,
        moe_d_ff=14336,
        activation="silu",
        rope_theta=1000000.0,
        tie_embeddings=False,
    )
