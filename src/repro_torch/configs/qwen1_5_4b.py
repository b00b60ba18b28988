"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family card] — dense MHA decoder
(n_kv_heads == n_heads), QKV bias."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_ff=6912,
        vocab=151936,
        rope_theta=1e6,
        qkv_bias=True,
    )
