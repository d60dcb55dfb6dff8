"""HuBERT X-Large [arXiv:2106.07447] — encoder-only audio transformer
(wav2vec2 backbone). The conv/mel frontend is a STUB: inputs are
precomputed frame embeddings of shape (B, S, frontend_dim); vocab_size is
the masked-prediction codebook size (504)."""
from .base import ModelConfig, register


@register("hubert-xlarge")
def hubert_xlarge() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        source="arXiv:2106.07447",
        num_layers=48,
        d_model=1280,
        vocab_size=504,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        ffn_type="dense",
        activation="gelu_plain",      # plain GELU FFN (no GLU)
        causal=False,                 # encoder-only, bidirectional
        frontend="audio",
        frontend_dim=512,             # conv feature extractor output dim
        rope_theta=0.0,               # learned/convolutional pos (we use none)
        tie_embeddings=False,
    )
