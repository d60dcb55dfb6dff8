"""Gemma-3 27B [hf:google/gemma-3-1b-pt family] — dense, 5:1 local:global
sliding-window attention pattern, 128k context, GeGLU."""
from .base import ModelConfig, register


@register("gemma3-27b")
def gemma3_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        source="hf:google/gemma-3-1b-pt",
        num_layers=62,
        d_model=5376,
        vocab_size=262144,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        ffn_type="dense",
        activation="gelu",            # GeGLU
        sliding_window=1024,
        layer_pattern="LLLLLG",       # 5 local : 1 global
        scale_embeddings=True,
        rope_theta=1000000.0,
        query_pre_attn_scalar=168.0,  # d_model / num_heads
        use_post_norm=True,
        norm_eps=1e-6,
    )
