"""Jamba-1.5-Large (398B) [arXiv:2403.19887] — hybrid Mamba+attention at a
1:7 attn:mamba interleave (1 attention layer per 8-layer unit), MoE (16
experts, top-2) on every other layer, dense FFN elsewhere."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65536,
        rope=False,  # Jamba attention layers are NoPE
        pattern=(
            "mamba", "mamba", "mamba", "attn",
            "mamba", "mamba", "mamba", "mamba",
        ),
        n_experts=16,
        top_k=2,
        moe_d_ff=24576,
        moe_every=2,
        d_state=16,
    )
