"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — fine-grained MoE: 128 experts,
top-8, expert FFN width 768, every layer MoE, head_dim 128."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=0,
        vocab=151936,
        rope_theta=1e6,
        n_experts=128,
        top_k=8,
        moe_d_ff=768,
        moe_every=1,
    )
