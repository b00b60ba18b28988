"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — Mistral-NeMo-style decoder
consuming ViT patch embeddings (vision encoder is a STUB per the harness
carve-out; a learned projector maps stubbed patch embeddings into the
backbone). 1024 patch tokens prefix the text sequence (early fusion)."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=131072,
        rope_theta=1e6,
        frontend="vision",
        frontend_tokens=1024,
    )
