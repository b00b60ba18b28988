"""StarCoder2-3B [arXiv:2402.19173] — dense GQA decoder, RoPE, native
sliding-window attention (4096), GELU MLP, learned biases."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab=49152,
        rope=True,
        rope_theta=1e5,
        qkv_bias=True,
        sliding_window=4096,
        ffn_act="gelu",
        norm="layernorm",
    )
