"""Mixture-of-Experts FFN with capacity-bounded gather routing, and its
expert-parallel form on the model axis.

Counterpart of ``repro/models/moe.py`` (the shared expert included).
Routing (per token): the top-k softmax gates over E experts from f32
router logits. Capacity: each expert takes at most
``C = min(max(int(T * top_k / E * capacity_factor), 8), T)`` of the ``T``
tokens, those with its largest gates; a token routed to an expert whose
slots are full is dropped there, and slots left over are padding (the
lowest-index tokens the expert was not routed, with gate 0).

The reference runs each expert under ``vmap``; here the experts are one
batch: the (E, T) gate matrix, one stable sort a row for the C slots, the
(E, C, d) gathered tokens, batched products with the stacked ``w1``,
``w3`` and ``w2``, and one f32 sum over experts of their (T, d) scatters,
rounded to the activations' dtype once, as XLA sums the reference's bf16
contributions. Ties pick the lower index first everywhere, as
``jax.lax.top_k`` does: a stable descending ``torch.sort`` (``torch.topk``
does not promise it). The products are plain torch, as they are plain JAX
in the reference (no Pallas kernel).

On the model axis (DTensor weights) the block is the reference's
``shard_map`` branch as a ``local_map`` region: when the experts are
sharded over one mesh dimension, each of its ranks routes the tokens and
computes the contributions of its ``E / |axis|`` experts (``e_offset =
rank * e_local``); the tokens stay sharded over the batch axes the weights
do not use when ``t % tok_shards == 0`` and ``t / tok_shards >= 8``, each
shard with ``cap_local = min(max(C // tok_shards, 8), t / tok_shards)``
slots an expert, and are replicated otherwise. The contributions are
summed in f32 over the expert (and FFN) ranks and rounded to the
activations' dtype once. Without expert sharding the region takes every
expert and the whole token set, the reference's global computation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import distributed
from ..distributed import einsum, shard
from .config import ModelConfig
from .spec import LeafSpec

__all__ = ["moe_specs", "capacity", "moe_block", "router_aux_loss"]


def moe_specs(cfg: ModelConfig) -> dict:
    """The router is an f32 leaf in a tree of the parameters' dtype."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s: dict = {
        "router": LeafSpec((d, e), (None, None), dtype=torch.float32),
        "w1": LeafSpec((e, d, f), ("experts", None, "ff")),
        "w3": LeafSpec((e, d, f), ("experts", None, "ff")),
        "w2": LeafSpec((e, f, d), ("experts", "ff", None)),
    }
    if cfg.shared_expert:
        s["sw1"] = LeafSpec((d, f), (None, "ff"))
        s["sw3"] = LeafSpec((d, f), (None, "ff"))
        s["sw2"] = LeafSpec((f, d), ("ff", None))
    return s


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, equal values in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """x2d: (T, d) -> gates (T, k) f32, idx (T, k)."""
    logits = x2d.float() @ router  # (T, E)
    gate_vals, idx = _top(logits, top_k)
    return torch.softmax(gate_vals, dim=-1), idx


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert has for ``tokens`` tokens (the reference's rule,
    Python float arithmetic in its order)."""
    return min(max(int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 8), tokens)


def _dispatch(gates: torch.Tensor, idx: torch.Tensor, n_experts: int, cap: int, e_offset: int = 0,
              e_local: int | None = None):
    """The C slots of experts ``e_offset .. e_offset + e_local`` (all of
    them by default): ``(sel (E, C) f32, slot_idx (E, C))``, the tokens with
    the expert's largest gates (ties: lower index), padded with the
    lowest-index tokens it was not routed (``sel = 0``). A token whose gate
    underflowed to 0 counts as not routed, as in the reference."""
    e_local = n_experts if e_local is None else e_local
    gate_e = torch.zeros(gates.shape[0], n_experts, dtype=gates.dtype, device=gates.device)
    gate_e = gate_e.scatter(1, idx, gates)[:, e_offset:e_offset + e_local].T  # (E, T)
    score = torch.where(gate_e > 0, gate_e, torch.full_like(gate_e, -1.0))
    top_score, slot_idx = _top(score, cap)
    return torch.clamp_min(top_score, 0.0), slot_idx


def _expert_sum(x2d, gates, idx, w1, w3, w2, cap: int, n_experts: int, e_offset: int = 0) -> torch.Tensor:
    """The f32 (T, d) sum of the contributions of the experts whose stacked
    weights are given (``w1``/``w3`` (E, d, f), ``w2`` (E, f, d)), the
    first of them expert ``e_offset`` of ``n_experts``."""
    t, d = x2d.shape
    e = w1.shape[0]
    sel, slot_idx = _dispatch(gates, idx, n_experts, cap, e_offset, e)
    xe = x2d[slot_idx]  # (E, C, d)
    h = F.silu(torch.matmul(xe, w1)) * torch.matmul(xe, w3)  # (E, C, f)
    ye = torch.matmul(h, w2) * sel[..., None].to(x2d.dtype)  # (E, C, d)
    # One expert's slots are distinct tokens: a scatter per expert row into
    # a dense (E, T, d) f32 buffer, summed over experts, is deterministic
    # (no atomics).
    buf = torch.zeros((e, t, d), dtype=torch.float32, device=x2d.device)
    buf = buf.scatter(1, slot_idx[..., None].expand(e, cap, d), ye.float())
    return buf.sum(0)


def _expert_compute(x2d, gates, idx, w1, w3, w2, cap: int) -> torch.Tensor:
    """(T, d) contribution of all experts, rounded once."""
    return _expert_sum(x2d, gates, idx, w1, w3, w2, cap, w1.shape[0]).to(x2d.dtype)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _moe_on_mesh(p: dict, x2d, cfg: ModelConfig):
    """The expert-parallel region (module docstring): (T, d) DTensor in,
    the f32 sum over the expert ranks, as a DTensor with the tokens'
    placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = p["w1"].device_mesh
    sizes = distributed.mesh_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    with distributed.set_mesh(mesh):
        w1spec = distributed.spec_for(("experts", None, "ff"), tuple(p["w1"].shape))
        w2spec = distributed.spec_for(("experts", "ff", None), tuple(p["w2"].shape))
    e_axes, f_axes = _axes(w1spec[0]), _axes(w1spec[2])
    t = x2d.shape[0]
    cap = capacity(t, cfg)
    ep = len(e_axes) == 1 and cfg.n_experts % sizes[e_axes[0]] == 0
    if ep:
        e_axis = e_axes[0]
        e_local = cfg.n_experts // sizes[e_axis]
        e_offset = distributed.axis_rank(mesh, e_axis) * e_local
        psum_axes = (e_axis,) + tuple(f_axes)
        baxes = tuple(a for a in distributed.batch_axes() if a in sizes and a not in psum_axes)
    else:
        e_offset, psum_axes, baxes = 0, tuple(f_axes), ()
    tok_shards = 1
    for a in baxes:
        tok_shards *= sizes[a]
    if baxes and t % tok_shards == 0 and t // tok_shards >= 8:
        cap_local = min(max(cap // tok_shards, 8), t // tok_shards)
        tok_pl = tuple(Shard(0) if a in baxes else Replicate() for a in names)
    else:
        cap_local = min(cap, t)
        tok_pl = (Replicate(),) * len(names)
    rep = (Replicate(),) * len(names)
    w1_pl, w2_pl = distributed.placements_of(mesh, w1spec), distributed.placements_of(mesh, w2spec)
    split = {names.index(a) for a in baxes} if tok_pl != rep else set()
    psum = {names.index(a) for a in psum_axes}

    def grad(pl):
        return tuple(q if isinstance(q, Shard) else (Partial() if i in split or i in psum else q)
                     for i, q in enumerate(pl))

    out_pl = tuple(Partial() if i in psum else q for i, q in enumerate(tok_pl))

    def local(x_l, router, w1, w3, w2):
        gates, idx = _route(x_l, router, cfg.top_k)
        return _expert_sum(x_l, gates, idx, w1, w3, w2, cap_local, cfg.n_experts, e_offset)

    out = distributed.local_region(
        local, (x2d, p["router"], p["w1"], p["w3"], p["w2"]), (tok_pl, rep, w1_pl, w1_pl, w2_pl), out_pl,
        in_grad_placements=(tuple(Partial() if i in psum else q for i, q in enumerate(tok_pl)), grad(rep),
                            grad(w1_pl), grad(w1_pl), grad(w2_pl)))
    return out.redistribute(mesh, tuple(Replicate() if i in psum else q for i, q in enumerate(out_pl)))


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    if distributed.is_dtensor(p["w1"]):
        out = _moe_on_mesh(p, x2d, cfg).to(x.dtype).reshape(b, s, d)
    else:
        gates, idx = _route(x2d, p["router"], cfg.top_k)
        out = _expert_compute(x2d, gates, idx, p["w1"], p["w3"], p["w2"], capacity(b * s, cfg)).reshape(b, s, d)
    if "sw1" in p:
        h = F.silu(einsum("bsd,df->bsf", x, p["sw1"])) * einsum("bsd,df->bsf", x, p["sw3"])
        out = out + einsum("bsf,fd->bsd", h, p["sw2"])
    return shard(out, "batch", None, None)


def router_aux_loss(x2d: torch.Tensor, router: torch.Tensor, top_k: int, n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (importance * load)."""
    logits = x2d.float() @ router
    importance = torch.softmax(logits, dim=-1).mean(0)
    _, idx = _top(logits, top_k)
    load = F.one_hot(idx, n_experts).float().sum(1).mean(0)
    return n_experts * (importance * load).sum()
