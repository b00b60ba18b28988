"""Architecture registry: ``--arch <id>`` resolution and reduced smoke
variants (a copy of ``repro/configs``: data only, so all ten come across;
a family the port cannot build yet fails in ``models.build_specs``).

Every assigned architecture has one module here citing its source; the
registry also exposes ``reduced(cfg)`` — the family-preserving small
variant used by CPU smoke tests (<=2 pattern units, d_model<=512,
<=4 experts).
"""

from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, SHAPES, ShapeConfig
from . import (
    starcoder2_3b,
    xlstm_350m,
    hubert_xlarge,
    pixtral_12b,
    qwen2_1_5b,
    minitron_8b,
    jamba_1_5_large_398b,
    qwen3_moe_30b_a3b,
    llama4_scout_17b_a16e,
    qwen1_5_4b,
)

_MODULES = {
    "starcoder2-3b": starcoder2_3b,
    "xlstm-350m": xlstm_350m,
    "hubert-xlarge": hubert_xlarge,
    "pixtral-12b": pixtral_12b,
    "qwen2-1.5b": qwen2_1_5b,
    "minitron-8b": minitron_8b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "qwen1.5-4b": qwen1_5_4b,
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].get_config()


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving smoke-scale variant of an architecture."""
    if cfg.pattern == ("attn",):
        pattern = ("attn",)
        n_layers = 2
    elif "mamba" in cfg.pattern:  # jamba: keep hybrid character
        pattern = ("mamba", "attn")
        n_layers = 2
    else:  # xlstm
        pattern = ("mlstm", "slstm")
        n_layers = 2
    moe = cfg.n_experts > 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=256,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=64,
        d_ff=512 if cfg.d_ff > 0 else 0,
        vocab=512,
        pattern=pattern,
        n_experts=4 if moe else 0,
        top_k=min(cfg.top_k, 2) if moe else 0,
        moe_d_ff=128 if moe else 0,
        moe_every=min(cfg.moe_every, len(pattern)) if moe else 1,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        frontend_tokens=16 if cfg.frontend == "vision" else 0,
    )


__all__ = ["ARCH_IDS", "get_config", "reduced", "SHAPES", "ShapeConfig"]
