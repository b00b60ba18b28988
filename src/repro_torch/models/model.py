"""Model assembly: spec tree, backbone, loss and prefill logits.

Counterpart of ``repro/models/model.py``. A model is ``reps`` repetitions
of a pattern unit; the parameters of each pattern position are stacked
over ``reps`` (leading axis), and :func:`backbone` loops over the reps,
indexing the stacked leaves, where the reference scans. The port builds
the attention mixer with the dense or MoE FFN (``qwen2-1.5b``,
``qwen1.5-4b``, ``minitron-8b``, ``starcoder2-3b``, ``qwen3-moe-30b-a3b``,
``llama4-scout-17b-a16e``) and the mLSTM and sLSTM mixers without an FFN
(``xlstm-350m``), full size and reduced. The Mamba mixer and the audio and
vision frontends raise ``NotImplementedError`` naming the ROADMAP item
that brings them. The reference's remat and indexed-parameter context
managers are mesh memory levers and come with ROADMAP A14; decode
(``serve_step`` and the caches) with A13.
"""

from __future__ import annotations

from typing import Any

import torch

from . import layers, moe, xlstm
from .config import ModelConfig
from .spec import stack_specs

__all__ = ["build_specs", "backbone", "train_loss", "prefill"]

Params = Any

# What the port cannot build yet, by the ROADMAP item that brings it.
_UNPORTED = {
    "mamba": "ROADMAP A12c (models/ssm.py and the hybrid pattern, after the mesh of A14)",
    "frontend": "ROADMAP A12e (the audio and vision frontends)",
}

_MIXER_SPECS = {"attn": layers.attn_specs, "mlstm": xlstm.mlstm_specs, "slstm": xlstm.slstm_specs}


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.encoder_only or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend / encoder-only head is not ported yet; {_UNPORTED['frontend']}"
        )
    for pos in range(cfg.unit):
        mix = cfg.mixer_at(pos)
        if mix not in _MIXER_SPECS:
            raise NotImplementedError(f"{cfg.name}: the {mix} mixer is not ported yet; {_UNPORTED[mix]}")


def build_specs(cfg: ModelConfig) -> dict:
    """Full parameter LeafSpec tree of an architecture."""
    _check_supported(cfg)
    blocks = []
    for pos in range(cfg.unit):
        unit: dict = {"norm1": layers.norm_specs(cfg), "mixer": _MIXER_SPECS[cfg.mixer_at(pos)](cfg)}
        f = cfg.ffn_at(pos)
        if f != "none":
            unit["norm2"] = layers.norm_specs(cfg)
            unit["ffn"] = layers.ffn_specs(cfg) if f == "dense" else moe.moe_specs(cfg)
        blocks.append(stack_specs(unit, cfg.reps))
    return {
        "embed": layers.embed_specs(cfg),
        "blocks": blocks,
        "final_norm": layers.norm_specs(cfg),
    }


def _index(tree, r: int):
    """Rep ``r`` of a stacked parameter tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, pos: int) -> torch.Tensor:
    mix = cfg.mixer_at(pos)
    h = layers.apply_norm(p["norm1"], x, cfg.norm_eps)
    if mix == "attn":
        h = layers.attention_block(p["mixer"], h, cfg, positions)
    elif mix == "mlstm":
        h = xlstm.mlstm_block(p["mixer"], h, cfg)
    else:
        h = xlstm.slstm_block(p["mixer"], h, cfg)
    x = x + h
    f = cfg.ffn_at(pos)
    if f != "none":
        h = layers.apply_norm(p["norm2"], x, cfg.norm_eps)
        x = x + (layers.ffn_block(p["ffn"], h, cfg) if f == "dense" else moe.moe_block(p["ffn"], h, cfg))
    return x


def backbone(params: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    _check_supported(cfg)
    for r in range(cfg.reps):
        for pos, stacked in enumerate(params["blocks"]):
            x = _apply_layer(_index(stacked, r), x, cfg, positions, pos)
    return layers.apply_norm(params["final_norm"], x, cfg.norm_eps)


def _embed_inputs(params: Params, batch: dict, cfg: ModelConfig):
    """Returns (x (B, S, d), positions (B, S), labels)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = layers.embed_tokens(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    return x, positions, batch.get("labels")


def train_loss(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token loss: the labels rolled left by one, the last position
    masked out (the reference's rule, applied to whatever labels the batch
    carries)."""
    x, positions, labels = _embed_inputs(params, batch, cfg)
    x = backbone(params, x, cfg, positions)
    logits = layers.lm_logits(params["embed"], x)
    shifted = torch.roll(labels, -1, dims=1)
    mask = torch.ones_like(labels, dtype=torch.bool)
    mask[:, -1] = False  # last position has no next token
    return layers.softmax_xent(logits, shifted, mask)


def prefill(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    x, positions, _ = _embed_inputs(params, batch, cfg)
    x = backbone(params, x, cfg, positions)
    return layers.lm_logits(params["embed"], x)
