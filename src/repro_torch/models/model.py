"""Model assembly: spec tree, backbone, loss, prefill logits and decode.

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
embeddings. :func:`serve_step` decodes one token over the caches of
:func:`init_cache`, one entry a pattern position with its leaves stacked
over ``reps`` as the reference's; the steps update the caches in place.
The reference's remat and indexed-parameter context managers and
``cache_logical`` are mesh levers and sharding metadata and come with
the model axis, ROADMAP A14b.
"""

from __future__ import annotations

from typing import Any

import torch

from . import layers, moe, ssm, xlstm
from .config import ModelConfig
from .spec import LeafSpec, stack_specs

__all__ = ["build_specs", "backbone", "train_loss", "prefill", "init_cache", "serve_step"]

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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> list:
    """The decode cache: one entry a pattern position, its leaves stacked
    ``(reps, ...)``. ``cache_len`` is the KV-cache length of attention
    positions (the ring's size when the sliding variant is active); the
    recurrent mixers carry O(1) state."""
    caches = []
    for pos in range(cfg.unit):
        mix = cfg.mixer_at(pos)
        if mix == "attn":
            c = layers.init_attn_cache(cfg, batch, cache_len, device)
        elif mix == "mamba":
            c = ssm.init_mamba_cache(cfg, batch, device)
        elif mix == "mlstm":
            c = xlstm.init_mlstm_cache(cfg, batch, device)
        else:
            c = xlstm.init_slstm_cache(cfg, batch, device)
        caches.append({k: v.expand((cfg.reps,) + v.shape).clone() for k, v in c.items()})
    return caches


def serve_step(params: Params, cache: list, batch: dict, pos: int, cfg: ModelConfig,
               window: int = 0) -> tuple[torch.Tensor, list]:
    """Decode ONE token. batch: ``{"tokens": (B, 1)}``; ``pos`` its position
    (an int). ``window > 0`` makes the attention caches rings of that many
    slots. Returns the (B, vocab) f32 logits and ``cache``, updated in
    place."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode path")
    x = layers.embed_tokens(params["embed"], batch["tokens"])
    for r in range(cfg.reps):
        for upos, stacked in enumerate(params["blocks"]):
            mix = cfg.mixer_at(upos)
            p, c = _index(stacked, r), _index(cache[upos], r)
            h = layers.apply_norm(p["norm1"], x, cfg.norm_eps)
            if mix == "attn":
                h, c_new = layers.decode_attention_block(p["mixer"], h, c, cfg, pos, window)
            elif mix == "mamba":
                h, c_new = ssm.mamba_decode_step(p["mixer"], h, c, cfg)
            elif mix == "mlstm":
                h, c_new = xlstm.mlstm_decode_step(p["mixer"], h, c, cfg)
            else:
                h, c_new = xlstm.slstm_decode_step(p["mixer"], h, c, cfg)
            for k, v in c_new.items():
                if v is not c[k]:
                    c[k].copy_(v)
            x = x + h
            f = cfg.ffn_at(upos)
            if f != "none":
                h = layers.apply_norm(p["norm2"], x, cfg.norm_eps)
                x = x + (layers.ffn_block(p["ffn"], h, cfg) if f == "dense" else moe.moe_block(p["ffn"], h, cfg))
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_eps)
    return layers.lm_logits(params["embed"], x)[:, 0], cache
