"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]
— VLM. The SigLIP/CLIP vision tower + projector are a STUB: inputs include
precomputed projected patch embeddings (B, num_patches, d_model slot via
frontend_dim) produced by anyres tiling (up to 5 tiles x 576 patches)."""
from .base import ModelConfig, register


@register("llava-next-mistral-7b")
def llava_next_mistral_7b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        num_layers=32,
        d_model=4096,
        vocab_size=32000,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        ffn_type="dense",
        activation="silu",
        rope_theta=1000000.0,
        frontend="vision",
        frontend_dim=1024,            # CLIP-L/14 hidden -> projector input
        num_patches=2880,             # anyres: 5 tiles x 576 patches
        tie_embeddings=False,
    )
