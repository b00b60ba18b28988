"""Model assembly: spec tree, backbone, loss and prefill logits.

Counterpart of ``repro/models/model.py``. A model is ``reps`` repetitions
of a pattern unit; the parameters of each pattern position are stacked
over ``reps`` (leading axis), and :func:`backbone` loops over the reps,
indexing the stacked leaves, where the reference scans. The port builds
every architecture of the registry, full size and reduced: the attention
mixer with the dense or MoE FFN, the mLSTM and sLSTM mixers, the Mamba
mixer in Jamba's hybrid pattern, the encoder-only head over the audio
frontend (``hubert-xlarge``: the mask token on the masked frames, a
classifier, the loss over the masked frames) and the vision frontend
(``pixtral-12b``: projected patches before the token embeddings). Both
frontends are the reference's stubs: the batch carries the frame or patch
embeddings. The reference's remat and indexed-parameter context managers
are mesh memory levers and come with ROADMAP A14; decode (``serve_step``
and the caches) with A13.
"""

from __future__ import annotations

from typing import Any

import torch

from . import layers, moe, ssm, xlstm
from .config import ModelConfig
from .spec import LeafSpec, stack_specs

__all__ = ["build_specs", "backbone", "train_loss", "prefill"]

Params = Any

_MIXER_SPECS = {
    "attn": layers.attn_specs,
    "mamba": ssm.mamba_specs,
    "mlstm": xlstm.mlstm_specs,
    "slstm": xlstm.slstm_specs,
}


def build_specs(cfg: ModelConfig) -> dict:
    """Full parameter LeafSpec tree of an architecture."""
    blocks = []
    for pos in range(cfg.unit):
        unit: dict = {"norm1": layers.norm_specs(cfg), "mixer": _MIXER_SPECS[cfg.mixer_at(pos)](cfg)}
        f = cfg.ffn_at(pos)
        if f != "none":
            unit["norm2"] = layers.norm_specs(cfg)
            unit["ffn"] = layers.ffn_specs(cfg) if f == "dense" else moe.moe_specs(cfg)
        blocks.append(stack_specs(unit, cfg.reps))
    tree: dict = {
        "embed": layers.embed_specs(cfg),
        "blocks": blocks,
        "final_norm": layers.norm_specs(cfg),
    }
    if cfg.encoder_only:
        tree["classifier"] = LeafSpec((cfg.d_model, cfg.vocab), (None, "vocab"))
        tree["mask_token"] = LeafSpec((cfg.d_model,), (None,), scale=0.02)
        del tree["embed"]["head"]
    if cfg.frontend == "vision":
        # the learned projector of the (stubbed) patch embeddings
        tree["projector"] = LeafSpec((cfg.d_model, cfg.d_model), (None, None))
    return tree


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
    elif mix == "mamba":
        h = ssm.mamba_block(p["mixer"], h, cfg)
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
    for r in range(cfg.reps):
        for pos, stacked in enumerate(params["blocks"]):
            x = _apply_layer(_index(stacked, r), x, cfg, positions, pos)
    return layers.apply_norm(params["final_norm"], x, cfg.norm_eps)


def _embed_inputs(params: Params, batch: dict, cfg: ModelConfig):
    """Returns (x (B, S, d), positions (B, S), loss labels, loss mask); the
    mask is None for plain token input."""
    if cfg.frontend == "audio":
        feats, mask = batch["feats"], batch["mask"]
        x = torch.where(mask[..., None], params["mask_token"].to(feats.dtype), feats)
        b, s, _ = x.shape
        return x, torch.arange(s, device=x.device).expand(b, s), batch.get("labels"), mask
    if cfg.frontend == "vision":
        # a bf16 patch of an f32 projector is widened first, as JAX promotes it
        proj = params["projector"]
        dt = torch.promote_types(batch["patches"].dtype, proj.dtype)
        patches = torch.einsum("bpd,de->bpe", batch["patches"].to(dt), proj.to(dt))
        tok_emb = layers.embed_tokens(params["embed"], batch["tokens"])
        x = torch.cat([patches.to(tok_emb.dtype), tok_emb], dim=1)
        b, s, _ = x.shape
        npatch = patches.shape[1]
        mask = torch.ones((b, s), dtype=torch.bool, device=x.device)
        mask[:, :npatch] = False
        labels = batch.get("labels")
        if labels is not None:
            # labels padded over the patch prefix (the mask leaves them out)
            labels = torch.cat([torch.zeros((b, npatch), dtype=labels.dtype, device=labels.device), labels], dim=1)
        return x, torch.arange(s, device=x.device).expand(b, s), labels, mask
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = layers.embed_tokens(params["embed"], tokens)
    return x, torch.arange(s, device=tokens.device).expand(b, s), batch.get("labels"), None


def _classifier_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dv->bsv", x, params["classifier"]).float()


def train_loss(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The encoder-only head's loss over the masked frames, with the labels
    as given; else the next-token loss: the labels rolled left by one and
    the last position masked out, with the frontend's mask (the reference's
    rule, applied to whatever labels the batch carries)."""
    x, positions, labels, mask = _embed_inputs(params, batch, cfg)
    x = backbone(params, x, cfg, positions)
    if cfg.encoder_only:
        return layers.softmax_xent(_classifier_logits(params, x), labels, mask)
    logits = layers.lm_logits(params["embed"], x)
    shifted = torch.roll(labels, -1, dims=1)
    mask = torch.ones_like(labels, dtype=torch.bool) if mask is None else mask.clone()
    mask[:, -1] = False  # last position has no next token
    return layers.softmax_xent(logits, shifted, mask)


def prefill(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    x, positions, _, _ = _embed_inputs(params, batch, cfg)
    x = backbone(params, x, cfg, positions)
    if cfg.encoder_only:
        return _classifier_logits(params, x)
    return layers.lm_logits(params["embed"], x)
