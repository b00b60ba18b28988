"""Mixture-of-Experts FFN with capacity-bounded gather routing, all experts
at once.

Counterpart of ``repro/models/moe.py`` without a mesh (its no-mesh branch
and the shared expert). Routing (per token): the top-k softmax gates over
E experts from f32 router logits. Capacity: each expert takes at most
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
in the reference (no Pallas kernel). The expert-parallel ``shard_map``
branch belongs to the model axis (ROADMAP A14b); the mesh's client axis
(:mod:`repro_torch.distributed`) leaves the experts whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _dispatch(gates: torch.Tensor, idx: torch.Tensor, n_experts: int, cap: int):
    """Each expert's C slots: ``(sel (E, C) f32, slot_idx (E, C))``, the
    tokens with its largest gates (ties: lower index), padded with the
    lowest-index tokens it was not routed (``sel = 0``). A token whose gate
    underflowed to 0 counts as not routed, as in the reference."""
    gate_e = torch.zeros(gates.shape[0], n_experts, dtype=gates.dtype, device=gates.device)
    gate_e = gate_e.scatter(1, idx, gates).T  # (E, T)
    score = torch.where(gate_e > 0, gate_e, torch.full_like(gate_e, -1.0))
    top_score, slot_idx = _top(score, cap)
    return torch.clamp_min(top_score, 0.0), slot_idx


def _expert_compute(x2d, gates, idx, w1, w3, w2, cap: int) -> torch.Tensor:
    """(T, d) contribution of all experts: w1/w3 (E, d, f), w2 (E, f, d)."""
    t, d = x2d.shape
    e = w1.shape[0]
    sel, slot_idx = _dispatch(gates, idx, e, cap)
    xe = x2d[slot_idx]  # (E, C, d)
    h = F.silu(torch.matmul(xe, w1)) * torch.matmul(xe, w3)  # (E, C, f)
    ye = torch.matmul(h, w2) * sel[..., None].to(x2d.dtype)  # (E, C, d)
    # One expert's slots are distinct tokens: a scatter per expert row into
    # a dense (E, T, d) f32 buffer, summed over experts, is deterministic
    # (no atomics) and rounds once.
    buf = torch.zeros((e, t, d), dtype=torch.float32, device=x2d.device)
    buf = buf.scatter(1, slot_idx[..., None].expand(e, cap, d), ye.float())
    return buf.sum(0).to(x2d.dtype)


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, idx = _route(x2d, p["router"], cfg.top_k)
    out = _expert_compute(x2d, gates, idx, p["w1"], p["w3"], p["w2"], capacity(b * s, cfg)).reshape(b, s, d)
    if "sw1" in p:
        h = F.silu(torch.einsum("bsd,df->bsf", x, p["sw1"])) * torch.einsum("bsd,df->bsf", x, p["sw3"])
        out = out + torch.einsum("bsf,fd->bsd", h, p["sw2"])
    return out


def router_aux_loss(x2d: torch.Tensor, router: torch.Tensor, top_k: int, n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (importance * load)."""
    logits = x2d.float() @ router
    importance = torch.softmax(logits, dim=-1).mean(0)
    _, idx = _top(logits, top_k)
    load = F.one_hot(idx, n_experts).float().sum(1).mean(0)
    return n_experts * (importance * load).sum()
