"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense GQA,
128k context."""
from .base import ModelConfig, register


@register("mistral-nemo-12b")
def mistral_nemo_12b() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        source="hf:mistralai/Mistral-Nemo-Base-2407",
        num_layers=40,
        d_model=5120,
        vocab_size=131072,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        ffn_type="dense",
        activation="silu",
        rope_theta=1000000.0,
        tie_embeddings=False,
    )
