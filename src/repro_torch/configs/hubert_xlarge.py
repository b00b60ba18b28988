"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only backbone (same arch as
wav2vec2); conv feature extractor is a STUB per the harness carve-out:
input_specs() provides precomputed frame embeddings. Masked-frame cluster
prediction over 504 k-means targets. RoPE substitutes the conv positional
embedding (positional information only; noted in DESIGN.md)."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab=504,
        rope=True,
        rope_theta=1e4,
        causal=False,
        encoder_only=True,
        frontend="audio",
        ffn_act="gelu",
        norm="layernorm",
    )
