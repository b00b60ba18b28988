"""Hierarchical count-tree rounds: clients -> edge aggregators -> root.

Counterpart of ``repro/fl/hierarchy.py``. Vote counts add, so a round need not funnel
all M clients through one server: the cohort splits into ``tree_edges``
contiguous slices (:func:`edge_slices`), each **edge** runs the streaming
round's chunk loop over its slice (``rounds._stream_chunks``, quantizer
rows, Byzantine membership and masks keyed by cohort position) and ships
the root only its ``(8 * p_bytes,)`` f32 count tensor, its active mass and
the synchronous heartbeat (the b-vote and metric sums).

* **Zero staleness.** Counts of 0/1-weighted bits are integers, so the
  root's sum over edges equals the streamed round's count carry, and the
  tree round (``edge_merge="sum"``) equals :func:`~repro_torch.fl.rounds.stream_fl_round`
  bit for bit in models, b and residuals, for any E (E need not divide M),
  under participation sampling and error feedback; the metric sums add in
  another order.
* **Buffered edges** (``edge_buffer = B > 0``): the asynchronous round's
  buffer one level up. Edge e writes slot ``e mod B`` with probability
  ``1 / (1 + latency)`` (uniform ``fold_in(key, 7)``), later edges winning a
  shared slot; slots age when no edge refreshes them, and the root sums
  the slots weighted ``(1 + age) ** -decay``.
* **Byzantine edges**: the first ``byz_edges`` edges ship forged tensors
  (:func:`repro_torch.core.attacks.apply_edge_attack`). ``edge_merge``
  ``"median"`` and ``"trimmed"`` merge the edges' vote *rates* ``N_i /
  mass`` per coordinate (the median, or the mean of the order statistics
  left after cutting ``edge_trim`` from each end) and rescale by the total
  mass.
* **Sharded edges** (``tree_shard``): rank ``k`` of the client group runs
  edges ``[k E/n, (k+1) E/n)`` over its block of the clients' data, and one
  gather a tensor of the stacked per-edge tensors, in rank order (for a
  campaign group, one gather a tensor for all its runs), gives every rank
  the whole edge axis, the reference's sharded ``out_specs``.
  Every rank then merges at the root as one process would: no sum crosses
  ranks, so the round equals the unsharded tree bit for bit, metrics too.

Float rules (the reference's under ``jit``): a rate is a true division by
the edge's mass; the median of an even number of edges is ``(a + b) *
0.5``; a trimmed mean is the sum of its order statistics, added in order,
times ``f32(1/n)``; a staleness-weighted sum adds the edges in order,
each weight's product fused into its add (XLA fuses the multiply into the
reduction as FMAs). The
root's estimate multiplies by the reciprocal of the merged mass, as every
weighted estimate of the port does. None of this has a kernel in the
reference; the edges' chunks launch the port's pack (or EF) kernel once a
chunk and the prox kernel once a local step.

A campaign group of E runs (:mod:`repro_torch.sim`) runs the round once,
with a leading E on the keys, the state, the root buffer and every
per-edge tensor: the chunks launch each kernel once for the group, and
every float step above is a function of one run's own values.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from .. import distributed, prng
from ..core import update_b_from_vote
from ..core.aggregation import mean_rows, recip32
from ..core.attacks import apply_edge_attack, edge_attack_id
from .rounds import (CellParams, RoundContext, RoundState, _add_in_order, _arrivals, _per_run, _staleness,
                     _stream_chunks, init_state)

__all__ = [
    "EDGE_MERGES",
    "TreeRoundState",
    "edge_slices",
    "init_tree_state",
    "tree_fl_round",
    "tree_shard_devices",
]

# Root merges of the stacked (E, 8 * p_bytes) edge count tensors: "sum" is
# the exact additive protocol, "median" and "trimmed" the robust rate-space
# merges.
EDGE_MERGES: tuple[str, ...] = ("sum", "median", "trimmed")


@dataclasses.dataclass(frozen=True, kw_only=True)
class TreeRoundState(RoundState):
    """A buffered tree's state: the synchronous fields and the root's
    buffer of ``edge_buffer`` shipped count tensors (unbuffered trees carry
    a plain :class:`~repro_torch.fl.rounds.RoundState`)."""

    edge_counts: torch.Tensor  # (B, 8 * p_bytes) f32 buffered edge count tensors
    edge_mass: torch.Tensor  # (B,) f32 buffered active masses
    edge_age: torch.Tensor  # (B,) int32 rounds since the slot's edge delivered
    edge_valid: torch.Tensor  # (B,) bool: the slot holds a delivery


def edge_slices(n: int, n_edges: int) -> list[tuple[int, int]]:
    """``(row0, n_e)`` cohort slices, one an edge: the first ``n mod E``
    edges take ``ceil(n/E)`` rows, the rest ``floor(n/E)``."""
    q, r = divmod(n, n_edges)
    out, row0 = [], 0
    for n_e in [q + 1] * r + [q] * (n_edges - r):
        out.append((row0, n_e))
        row0 += n_e
    return out


def init_tree_state(ctx: RoundContext, b_init=None) -> TreeRoundState:
    """Fresh buffered-tree state: an empty edge buffer beside the
    synchronous fields."""
    n_buf, dev = ctx.cfg.edge_buffer, ctx.device
    p_bytes = ctx.pipeline.compressor.wire_bytes(ctx.d)
    return TreeRoundState(
        **vars(init_state(ctx, b_init)),
        edge_counts=torch.zeros((n_buf, 8 * p_bytes), dtype=torch.float32, device=dev),
        edge_mass=torch.zeros(n_buf, dtype=torch.float32, device=dev),
        edge_age=torch.zeros(n_buf, dtype=torch.int32, device=dev),
        edge_valid=torch.zeros(n_buf, dtype=torch.bool, device=dev),
    )


def tree_shard_devices(ctx: RoundContext) -> int:
    """Ranks the edge reductions spread over (1: every edge on this rank)."""
    return distributed.group_size(ctx.group) if ctx.cfg.tree_shard else 1


def _sum_edges(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over the edge axis ``dim``, the edges added in order (a group's
    tensors carry their runs before it, each run's sum its own)."""
    out = x.select(dim, 0)
    for j in range(1, x.shape[dim]):
        out = out + x.select(dim, j)
    return out


def _root_merge(cfg, counts_e: torch.Tensor, mass_e: torch.Tensor, weights: torch.Tensor | None):
    """Merge the (E', 8P) edge tensors into the root's (counts, mass):
    the (staleness-weighted) sum, or a robust merge of the vote rates
    rescaled by the total mass. A group's (E, E', 8P) tensors merge each
    run's edges on their own (the sort too)."""
    if cfg.edge_merge == "sum":
        if weights is None:
            return _sum_edges(counts_e, -2), _sum_edges(mass_e, -1)
        counts, mass = torch.zeros_like(counts_e.select(-2, 0)), torch.zeros_like(mass_e.select(-1, 0))
        for j in range(counts_e.shape[-2]):
            w = weights.select(-1, j)
            counts = prng._fma(w.unsqueeze(-1), counts_e.select(-2, j), counts)
            mass = prng._fma(w, mass_e.select(-1, j), mass)
        return counts, mass
    rates = counts_e / torch.clamp(mass_e, min=1.0).unsqueeze(-1)
    ordered = torch.sort(rates, dim=-2).values
    n = rates.shape[-2]
    if cfg.edge_merge == "median":
        mid = ordered.select(-2, n // 2)
        rate = mid if n % 2 else (ordered.select(-2, n // 2 - 1) + mid) * 0.5
    else:  # "trimmed"
        t = cfg.edge_trim
        rate = _sum_edges(ordered[..., t:n - t, :], -2) * recip32(n - 2 * t)
    mass = _sum_edges(mass_e, -1)
    return rate * mass.unsqueeze(-1), mass


def tree_fl_round(
    ctx: RoundContext, params: CellParams, key: torch.Tensor, state: RoundState, batches: dict
) -> tuple[RoundState, dict]:
    """One hierarchical round: the edges' chunk loops, the edge attack, the
    root buffer and merge, the estimate and the b-vote.

    The client side is the streaming round's (participation sampling, key
    schedule, attacks), with ``batches = {"key": kb}``. Metrics: those of
    :func:`~repro_torch.fl.rounds.stream_fl_round` and ``edge_mass_min``
    (the lightest edge's shipped mass); a buffered tree adds ``buf_fill``
    and ``mean_age``.

    A group of E runs, as :func:`~repro_torch.fl.rounds.stream_fl_round`'s
    (keys (E, 2), a state with a leading E, ``params`` one value a run):
    each edge's chunk loop launches each kernel once a chunk for the
    group; each run draws its own cohort and arrivals (from its f64
    latency), weighs its slots with its own decay (an (E,) f32 device
    tensor), and its edge attack, root merge (the median's sort over its
    own edges), estimate and metrics are its single round's.
    """
    cfg, d, dev = ctx.cfg, ctx.d, ctx.device
    n, n_edges, n_buf = cfg.n_active, cfg.tree_edges, cfg.edge_buffer
    lead = tuple(key.shape[:-1])
    server = ctx.pipeline.server
    if cfg.participation < 1.0:
        with record_function("round.sample"):
            sel = torch.stack([prng.choice(prng.fold_in(k, 99), cfg.n_clients, (n,)) for k in key.view(-1, 2)])
            sel = sel.view(lead + (n,))
    else:
        sel = torch.arange(cfg.n_clients, dtype=torch.int64, device=dev).expand(lead + (cfg.n_clients,))
    k_att, k_q = prng.split(prng.fold_in(key, 1), 2).unbind(-2)
    n_byz = int(n * cfg.byz_frac)
    limit = min(n, int(params.m_active)) if ctx.masked else n

    group = ctx.group if cfg.tree_shard else None
    slices = edge_slices(n, n_edges)
    e_loc = n_edges // distributed.group_size(group)
    mine = slices[distributed.group_rank(group) * e_loc:][:e_loc]
    edges, planes = [], None
    for row0, n_e in mine:
        acc, e_vote, e_losses, e_dsum, e_wsum, w_locals, residuals = _stream_chunks(
            ctx, params, batches["key"], k_att, k_q, state, sel[..., row0:row0 + n_e], n_byz, True, limit,
            row0=row0, planes=planes, data=batches.get("data"),
        )
        planes = (w_locals, residuals)
        e_loss = _per_run(_add_in_order, lead, e_losses)
        edges.append((acc, torch.stack([e_vote, e_loss, e_wsum], -1), e_dsum))
    w_locals, residuals = planes
    # each tensor's edge axis just before its last: (E', X), a group's (E, E', X)
    counts_f, heartbeat, dsums = (torch.stack(x, -2) for x in zip(*edges))
    if group is not None:
        with record_function("round.collectives"):
            # every rank's edges in rank order, the edge axis whole: one
            # gather a tensor for the whole group
            counts_f, heartbeat, dsums = (distributed.all_gather_rows(x, group).movedim(0, -3).flatten(-3, -2)
                                          for x in (counts_f, heartbeat, dsums))
    mass_f = heartbeat[..., 2]
    vote, loss, dsum = 0.0, 0.0, 0.0
    for j in range(n_edges):
        vote, loss, dsum = vote + heartbeat[..., j, 0], loss + heartbeat[..., j, 1], dsum + dsums[..., j, :]

    with record_function("round.estimate"):
        wsum = _sum_edges(mass_f, -1)
        counts_s, mass_s = counts_f, mass_f
        if cfg.byz_edges:
            byz_mask = torch.arange(n_edges, device=dev) < cfg.byz_edges
            if n_buf:
                slot_of = torch.arange(n_edges, device=dev) % n_buf
                prev = (state.edge_counts[..., slot_of, :], state.edge_mass[..., slot_of],
                        state.edge_valid[..., slot_of])
            else:
                prev = (torch.zeros_like(counts_f), torch.zeros_like(mass_f),
                        torch.zeros(mass_f.shape, dtype=torch.bool, device=dev))
            counts_s, mass_s = apply_edge_attack(edge_attack_id(cfg.edge_attack), counts_f, mass_f, *prev, byz_mask)
        extra = {}
        if n_buf:
            # the asynchronous buffer one level up: edge e -> slot e mod B,
            # later edges winning a shared slot, misses age their slot
            delivered = _arrivals(key, params.latency, n_edges)
            buf_c, buf_m = state.edge_counts.clone(), state.edge_mass.clone()
            hit = torch.zeros_like(state.edge_valid)
            for g0 in range(0, n_edges, n_buf):
                got = delivered[..., g0:g0 + n_buf]
                k = got.shape[-1]
                buf_c[..., :k, :] = torch.where(got.unsqueeze(-1), counts_s[..., g0:g0 + k, :], buf_c[..., :k, :])
                buf_m[..., :k] = torch.where(got, mass_s[..., g0:g0 + k], buf_m[..., :k])
                hit[..., :k] |= got
            age = torch.where(hit, torch.zeros_like(state.edge_age), state.edge_age + 1)
            valid = state.edge_valid | hit
            weights = _staleness(age, params.staleness_decay, valid)
            counts_root, mass_root = _root_merge(cfg, buf_c, buf_m, weights)
            extra = dict(edge_counts=buf_c, edge_mass=buf_m, edge_age=age, edge_valid=valid)
        else:
            counts_root, mass_root = _root_merge(cfg, counts_s, mass_s, None)
        b_vec = ctx.pipeline.compressor.b_vector(d, state.b.b)
        theta = _per_run(server.finalize_weighted, lead, counts_root, mass_root, b_vec)
    with record_function("round.finish"):
        b_new = update_b_from_vote(state.b, vote, cfg.bctrl)
        new_state = dataclasses.replace(state, w_global=state.w_global + theta, w_locals=w_locals, b=b_new,
                                        residuals=residuals, **extra)
        recip = torch.reciprocal(wsum.clamp(min=1.0))
        metrics = {
            "loss": loss * recip,
            "b": b_new.b,
            "theta_mse": _per_run(lambda t, ds, r: mean_rows((t - ds * r) ** 2), lead, theta, dsum, recip),
            "edge_mass_min": mass_f.amin(-1),
            "theta": theta,
        }
        if n_buf:
            n_valid = valid.float().sum(-1)
            metrics["buf_fill"] = n_valid * recip32(n_buf)
            metrics["mean_age"] = (age.float() * valid).sum(-1) / n_valid.clamp(min=1.0)
    return new_state, metrics
