"""Minitron-8B [arXiv:2407.14679] — width-pruned Nemotron-4; dense GQA."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab=256000,
        rope_theta=1e4,
    )
