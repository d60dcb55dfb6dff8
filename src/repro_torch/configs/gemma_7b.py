"""Gemma 7B [arXiv:2403.08295] — dense, GeGLU, head_dim=256 (16 heads,
kv=16; the 2B sibling uses MQA)."""
from .base import ModelConfig, register


@register("gemma-7b")
def gemma_7b() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        source="arXiv:2403.08295",
        num_layers=28,
        d_model=3072,
        vocab_size=256000,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        ffn_type="dense",
        activation="gelu",           # GeGLU
        scale_embeddings=True,
        rope_theta=10000.0,
    )
