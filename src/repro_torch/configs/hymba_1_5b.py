"""Hymba-1.5B [arXiv:2411.13676] — hybrid-head: parallel attention + mamba
heads within every layer; sliding-window attention on most layers."""
from .base import ModelConfig, register


@register("hymba-1.5b")
def hymba_1_5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        source="arXiv:2411.13676",
        num_layers=32,
        d_model=1600,
        vocab_size=32001,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        block_type="hybrid",
        ffn_type="dense",
        activation="silu",
        ssm_state=16,
        ssm_d_inner=3200,
        ssm_conv=4,
        # hymba: 3 full-attention layers (first/middle/last), rest SWA.
        sliding_window=1024,
        layer_pattern="GLLLLLLLLLLLLLLG" + "LLLLLLLLLLLLLLLG",
        rope_theta=10000.0,
    )
