"""Model assembly: spec tree, backbone, loss, prefill logits and decode.

Counterpart of ``repro/models/model.py``. A model is ``reps`` repetitions
of a pattern unit; the parameters of each pattern position are stacked
over ``reps`` (leading axis), and :func:`backbone` loops over the reps,
each stacked leaf taken apart once a call, where the reference scans. The port builds
every architecture of the registry, full size and reduced: the attention
mixer with the dense or MoE FFN, the mLSTM and sLSTM mixers, the Mamba
mixer in Jamba's hybrid pattern, the encoder-only head over the audio
frontend (``hubert-xlarge``: the mask token on the masked frames, a
classifier, the loss over the masked frames) and the vision frontend
(``pixtral-12b``: projected patches before the token embeddings). Both
frontends are the reference's stubs: the batch carries the frame or patch
embeddings. :func:`serve_step` decodes one token over the caches of
:func:`init_cache`, one entry a pattern position with its leaves stacked
over ``reps`` as the reference's; the steps update the caches in place;
:func:`cache_logical` gives their logical axes.

Remat (the reference's levers): :func:`backbone` checkpoints each pattern
unit by default (``torch.utils.checkpoint``, non-reentrant), so the
backward recomputes the unit's forward, unless :func:`unit_remat` turns
it off (the trainer does, by default); :func:`inner_remat` nests a
checkpoint around each layer inside the unit; :func:`remat_policy`
``"dots"`` keeps the outputs of matrix products without batch dimensions
(``aten.mm`` / ``aten.addmm``, JAX's ``dots_with_no_batch_dims_saveable``)
and recomputes the rest. None of them changes a bit of the forward or the
gradients. The parameters may be DTensors (the model axis,
:mod:`repro_torch.distributed`): each entry point then runs on their mesh.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .. import distributed
from ..distributed import einsum
from . import layers, moe, ssm, xlstm
from .config import ModelConfig
from .spec import LeafSpec, stack_specs

__all__ = ["build_specs", "backbone", "train_loss", "prefill", "init_cache", "cache_logical", "serve_step",
           "remat_policy", "unit_remat", "inner_remat", "indexed_params"]

Params = Any

# Checkpoint each pattern unit where ``backbone``'s ``remat`` asks it (off:
# the caller's choice for every backbone under the context).
_UNIT_REMAT: contextvars.ContextVar[bool] = contextvars.ContextVar("repro_torch_unit_remat", default=True)

# Remat each layer inside the pattern unit too (nested under the unit's
# checkpoint): the unit's backward then holds one layer's recomputed
# activations at a time.
_INNER_REMAT: contextvars.ContextVar[bool] = contextvars.ContextVar("repro_torch_inner_remat", default=False)

# "full" recomputes the whole unit in the backward; "dots" saves the
# outputs of matrix products without batch dimensions.
_REMAT_POLICY: contextvars.ContextVar[str] = contextvars.ContextVar("repro_torch_remat_policy", default="full")
REMAT_POLICIES = ("full", "dots")


@contextlib.contextmanager
def remat_policy(name: str):
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, got {name!r}")
    tok = _REMAT_POLICY.set(name)
    try:
        yield
    finally:
        _REMAT_POLICY.reset(tok)


@contextlib.contextmanager
def indexed_params(on: bool = True):
    """The reference's lever: its scan then indexes the stacked tree inside
    the body, so one pattern unit's parameters are gathered at a time. The
    port's layer loop always takes each rep's parameters as views of its
    shards and gathers them where the unit uses them, so the context is
    kept for the reference's callers (the dry run's variant) and changes
    nothing here."""
    yield


@contextlib.contextmanager
def unit_remat(on: bool = True):
    """Let :func:`backbone` checkpoint its pattern units (on, the default)
    or not, whatever its ``remat`` says: the trainer's lever
    (``DistFLConfig.remat``)."""
    tok = _UNIT_REMAT.set(on)
    try:
        yield
    finally:
        _UNIT_REMAT.reset(tok)


@contextlib.contextmanager
def inner_remat(on: bool = True):
    tok = _INNER_REMAT.set(on)
    try:
        yield
    finally:
        _INNER_REMAT.reset(tok)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the matrix products without batch dimensions; recompute the
    rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _in_this_context(fn):
    """``fn`` run, whenever it is called (the backward's recomputation
    included, which may run on another thread), in this context: these
    context variables (the mesh, the rules, the levers) and, on a mesh,
    plain tensors taken as replicated."""
    ctx = contextvars.copy_context()
    on_mesh = distributed.current_mesh() is not None

    def run(*args):
        def body():
            if not on_mesh:
                return fn(*args)
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                return fn(*args)

        return ctx.copy().run(body)

    return run


def _checkpoint(fn, *args):
    """``fn(*args)`` under the current remat policy; without gradients it
    just runs."""
    if not torch.is_grad_enabled():
        return fn(*args)
    fn = _in_this_context(fn)
    if _REMAT_POLICY.get() == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)

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


def _apply_unit(unit_params: list, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    nested = _INNER_REMAT.get()
    for pos, p in enumerate(unit_params):
        if nested:
            x = _checkpoint(functools.partial(_apply_layer, cfg=cfg, positions=positions, pos=pos), p, x)
        else:
            x = _apply_layer(p, x, cfg, positions, pos)
    return x


def _unstack(tree, reps: int) -> list:
    """The ``reps`` units of a stacked parameter tree, each leaf taken apart
    once along its leading axis (views): the backward then writes each
    stacked gradient once, as one stack, where a unit's index would write a
    zero tensor of the whole leaf for every unit and add them up. On a
    DTensor leaf the stacked gradient keeps the leaf's placements."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(reps)]
    if distributed.is_dtensor(tree):
        return list(_UnbindKeepingPlacements.apply(tree))
    return list(torch.unbind(tree))


class _UnbindKeepingPlacements(torch.autograd.Function):
    """``torch.unbind`` of a DTensor along dim 0 whose backward stacks the
    parts' gradients, each laid out as its part, into the leaf's own
    placements. DTensor's own unbind leaves them pending sums over the
    FSDP axis: every rank would hold each stacked gradient whole along
    that axis until one reduction of the whole leaf. A leaf sharded along
    its layer axis (FSDP's rule where that is the only dimension the axis
    divides) is gathered whole along it first (such leaves are the
    mixers' per-channel vectors); the stack of its parts' gradients is
    then whole along it, and each rank keeps its own layers of it."""

    @staticmethod
    def forward(ctx, stacked):
        from torch.distributed.tensor import Replicate

        ctx.mesh, ctx.placements, ctx.shape = stacked.device_mesh, tuple(stacked.placements), tuple(stacked.shape)
        ctx.whole = tuple(Replicate() if p.is_shard(0) else p for p in ctx.placements)
        if ctx.whole != ctx.placements:
            stacked = stacked.redistribute(ctx.mesh, ctx.whole)
        parts = stacked.unbind(0)
        ctx.part_placements = parts[0].placements
        return parts

    @staticmethod
    def backward(ctx, *grads):
        # a part the loss does not read comes as zeros (materialized grads)
        pieces = [g.redistribute(ctx.mesh, ctx.part_placements).to_local() for g in grads]
        grad = distributed.from_shard(torch.stack(pieces), ctx.mesh, ctx.whole, ctx.shape)
        return grad if ctx.whole == ctx.placements else grad.redistribute(ctx.mesh, ctx.placements)


def backbone(params: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
             remat: bool = True) -> torch.Tensor:
    """The reps of the pattern unit, each unit under a checkpoint unless
    ``remat`` is off (or :func:`unit_remat` turns it off), then the final
    norm. Each stacked leaf is taken apart once a call (:func:`_unstack`),
    so the backward's traffic is linear in depth, as the reference's scan."""
    remat = remat and _UNIT_REMAT.get()
    for unit in zip(*(_unstack(stacked, cfg.reps) for stacked in params["blocks"])):
        unit = list(unit)
        if remat:
            x = _checkpoint(functools.partial(_apply_unit, cfg=cfg, positions=positions), unit, x)
        else:
            x = _apply_unit(unit, x, cfg, positions)
    return layers.apply_norm(params["final_norm"], x, cfg.norm_eps)


def _embed_inputs(params: Params, batch: dict, cfg: ModelConfig):
    """Returns (x (B, S, d), positions (B, S), loss labels, loss mask); the
    mask is None for plain token input. On the model axis the inputs and
    the positions are laid out by their logical axes (the batch over the
    batch axes), as the reference's ``in_shardings`` lay them out."""
    if not distributed.has_dtensors(params):
        return _embed(params, batch, cfg)
    mesh = distributed.current_mesh()

    def on_mesh(v):
        if distributed.is_dtensor(v):
            return v
        return distributed.keep_shard(v, mesh, distributed.placements_for(
            mesh, ("batch",) + (None,) * (v.dim() - 1), tuple(v.shape)))

    x, positions, labels, mask = _embed(params, {k: on_mesh(v) for k, v in batch.items()}, cfg)
    return x, on_mesh(positions), labels, mask


def _embed(params: Params, batch: dict, cfg: ModelConfig):
    if cfg.frontend == "audio":
        feats, mask = batch["feats"], batch["mask"]
        x = torch.where(mask[..., None], params["mask_token"].to(feats.dtype), feats)
        b, s, _ = x.shape
        return x, torch.arange(s, device=x.device).expand(b, s), batch.get("labels"), mask
    if cfg.frontend == "vision":
        # a bf16 patch of an f32 projector is widened first, as JAX promotes it
        proj = params["projector"]
        dt = torch.promote_types(batch["patches"].dtype, proj.dtype)
        patches = einsum("bpd,de->bpe", batch["patches"].to(dt), proj.to(dt))
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
    return einsum("bsd,dv->bsv", x, params["classifier"]).float()


def train_loss(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The encoder-only head's loss over the masked frames, with the labels
    as given; else the next-token loss: the labels rolled left by one and
    the last position masked out, with the frontend's mask (the reference's
    rule, applied to whatever labels the batch carries)."""
    with distributed.mesh_context(params):
        return _train_loss(params, batch, cfg)


def _train_loss(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    x, positions, labels, mask = _embed_inputs(params, batch, cfg)
    x = backbone(params, x, cfg, positions)
    if cfg.encoder_only:
        return layers.softmax_xent(_classifier_logits(params, x), labels, mask)
    return layers.next_token_xent(layers.lm_logits(params["embed"], x), labels, mask)


def prefill(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    with distributed.mesh_context(params):
        return _prefill(params, batch, cfg)


def _prefill(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
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


def cache_logical(cfg: ModelConfig) -> list:
    """The logical axes of :func:`init_cache`'s leaves (a leading replicated
    ``reps`` axis on each mixer's own)."""
    table = {"attn": layers.attn_cache_logical, "mamba": ssm.mamba_cache_logical,
             "mlstm": xlstm.mlstm_cache_logical, "slstm": xlstm.slstm_cache_logical}
    return [{k: (None,) + tuple(v) for k, v in table[cfg.mixer_at(pos)]().items()} for pos in range(cfg.unit)]


def serve_step(params: Params, cache: list, batch: dict, pos: int, cfg: ModelConfig,
               window: int = 0) -> tuple[torch.Tensor, list]:
    """Decode ONE token. batch: ``{"tokens": (B, 1)}``; ``pos`` its position
    (an int). ``window > 0`` makes the attention caches rings of that many
    slots. Returns the (B, vocab) f32 logits and ``cache``, updated in
    place."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode path")
    with distributed.mesh_context(params):
        return _serve_step(params, cache, batch, pos, cfg, window)


def _serve_step(params: Params, cache: list, batch: dict, pos: int, cfg: ModelConfig, window: int):
    # DTensor caches are not written in place: each rep's new cache is
    # kept and the stacks are rebuilt at the end
    sharded = distributed.has_dtensors(cache)
    new_caches = [[] for _ in range(cfg.unit)]
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
            if sharded:
                new_caches[upos].append(c_new)
            else:
                for k, v in c_new.items():
                    if v is not c[k]:
                        c[k].copy_(v)
            x = x + h
            f = cfg.ffn_at(upos)
            if f != "none":
                h = layers.apply_norm(p["norm2"], x, cfg.norm_eps)
                x = x + (layers.ffn_block(p["ffn"], h, cfg) if f == "dense" else moe.moe_block(p["ffn"], h, cfg))
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_eps)
    if sharded:
        cache = [{k: torch.stack([c[k] for c in reps]) for k in reps[0]} for reps in new_caches]
    return layers.lm_logits(params["embed"], x)[:, 0], cache
