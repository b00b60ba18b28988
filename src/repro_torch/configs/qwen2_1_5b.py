"""Qwen2-1.5B [arXiv:2407.10671] — dense GQA decoder with QKV bias."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        rope_theta=1e6,
        qkv_bias=True,
    )
