"""Falcon-Mamba 7B [arXiv:2410.05355] — pure mamba1 SSM, attention-free,
no FFN (the mamba mixer IS the layer)."""
from .base import ModelConfig, register


@register("falcon-mamba-7b")
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        source="arXiv:2410.05355",
        num_layers=64,
        d_model=4096,
        vocab_size=65024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        block_type="mamba",
        ffn_type="none",
        ssm_state=16,
        ssm_d_inner=8192,
        ssm_conv=4,
        ssm_dt_rank=256,
    )
