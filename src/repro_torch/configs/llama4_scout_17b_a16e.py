"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE with 16
routed experts (top-1) + shared expert on every layer; early-fusion
multimodal in the original (text backbone here; the harness assigns the
[moe] type). Native attention is chunked-8k on most layers; we model full
attention with the sliding-window variant available for long_500k."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=0,
        vocab=202048,
        rope_theta=5e5,
        n_experts=16,
        top_k=1,
        moe_d_ff=8192,
        moe_every=1,
        shared_expert=True,
    )
