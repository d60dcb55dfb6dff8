"""Gemma-2 9B [arXiv:2408.00118] — dense, alternating local/global
attention, logit softcapping, post-norms."""
from .base import ModelConfig, register


@register("gemma2-9b")
def gemma2_9b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        source="arXiv:2408.00118",
        num_layers=42,
        d_model=3584,
        vocab_size=256000,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        ffn_type="dense",
        activation="gelu",            # GeGLU
        sliding_window=4096,
        layer_pattern="LG",           # alternating local / global
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        query_pre_attn_scalar=224.0,  # d_model / num_heads
        use_post_norm=True,
        scale_embeddings=True,
        rope_theta=10000.0,
    )
