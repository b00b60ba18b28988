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
  gather a tensor of the stacked per-edge tensors, in rank order, gives
  every rank the whole edge axis, the reference's sharded ``out_specs``.
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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from .. import distributed, prng
from ..core import staleness_weights, update_b_from_vote
from ..core.aggregation import mean_rows, recip32
from ..core.attacks import apply_edge_attack, edge_attack_id
from .rounds import CellParams, RoundContext, RoundState, _add_in_order, _stream_chunks, init_state

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


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (edge) axis, the rows added in order."""
    out = x[0]
    for row in x[1:]:
        out = out + row
    return out


def _root_merge(cfg, counts_e: torch.Tensor, mass_e: torch.Tensor, weights: torch.Tensor | None):
    """Merge the (E', 8P) edge tensors into the root's (counts, mass):
    the (staleness-weighted) sum, or a robust merge of the vote rates
    rescaled by the total mass."""
    if cfg.edge_merge == "sum":
        if weights is None:
            return _sum_rows(counts_e), _sum_rows(mass_e)
        counts, mass = torch.zeros_like(counts_e[0]), torch.zeros_like(mass_e[0])
        for w, c, m in zip(weights, counts_e, mass_e):
            counts, mass = prng._fma(w, c, counts), prng._fma(w, m, mass)
        return counts, mass
    rates = counts_e / torch.clamp(mass_e, min=1.0)[:, None]
    ordered = torch.sort(rates, dim=0).values
    n = rates.shape[0]
    if cfg.edge_merge == "median":
        rate = ordered[n // 2] if n % 2 else (ordered[n // 2 - 1] + ordered[n // 2]) * 0.5
    else:  # "trimmed"
        t = cfg.edge_trim
        rate = _sum_rows(ordered[t:n - t]) * recip32(n - 2 * t)
    mass = _sum_rows(mass_e)
    return rate * mass, mass


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
    """
    cfg, d, dev = ctx.cfg, ctx.d, ctx.device
    n, n_edges, n_buf = cfg.n_active, cfg.tree_edges, cfg.edge_buffer
    server = ctx.pipeline.server
    if cfg.participation < 1.0:
        with record_function("round.sample"):
            sel = prng.choice(prng.fold_in(key, 99), cfg.n_clients, (n,))
    else:
        sel = torch.arange(cfg.n_clients, dtype=torch.int64, device=dev)
    k_att, k_q = prng.split(prng.fold_in(key, 1), 2)
    n_byz = int(n * cfg.byz_frac)
    limit = min(n, int(params.m_active)) if ctx.masked else n

    group = ctx.group if cfg.tree_shard else None
    slices = edge_slices(n, n_edges)
    e_loc = n_edges // distributed.group_size(group)
    mine = slices[distributed.group_rank(group) * e_loc:][:e_loc]
    edges, planes = [], None
    for row0, n_e in mine:
        acc, e_vote, e_losses, e_dsum, e_wsum, w_locals, residuals = _stream_chunks(
            ctx, params, batches["key"], k_att, k_q, state, sel[row0:row0 + n_e], n_byz, True, limit,
            row0=row0, planes=planes,
        )
        planes = (w_locals, residuals)
        e_loss = _add_in_order(e_losses)
        edges.append((acc, torch.stack([e_vote, e_loss, e_wsum]), e_dsum))
    w_locals, residuals = planes
    counts_f, heartbeat, dsums = (torch.stack(x) for x in zip(*edges))
    if group is not None:
        with record_function("round.collectives"):
            # every rank's edges, stacked in rank order: the edge axis whole
            counts_f, heartbeat, dsums = (distributed.all_gather_rows(x, group).flatten(0, 1)
                                          for x in (counts_f, heartbeat, dsums))
    mass_f = heartbeat[:, 2]
    vote, loss, dsum = 0.0, 0.0, 0.0
    for e_vote, e_loss, e_dsum in zip(heartbeat[:, 0], heartbeat[:, 1], dsums):
        vote, loss, dsum = vote + e_vote, loss + e_loss, dsum + e_dsum

    with record_function("round.estimate"):
        wsum = _sum_rows(mass_f)
        counts_s, mass_s = counts_f, mass_f
        if cfg.byz_edges:
            byz_mask = torch.arange(n_edges, device=dev) < cfg.byz_edges
            if n_buf:
                slot_of = torch.arange(n_edges, device=dev) % n_buf
                prev = (state.edge_counts[slot_of], state.edge_mass[slot_of], state.edge_valid[slot_of])
            else:
                prev = (torch.zeros_like(counts_f), torch.zeros_like(mass_f),
                        torch.zeros(n_edges, dtype=torch.bool, device=dev))
            counts_s, mass_s = apply_edge_attack(edge_attack_id(cfg.edge_attack), counts_f, mass_f, *prev, byz_mask)
        extra = {}
        if n_buf:
            # the asynchronous buffer one level up: edge e -> slot e mod B,
            # later edges winning a shared slot, misses age their slot
            p_arrive = float(np.float32(1.0 / (1.0 + params.latency)))
            delivered = prng.uniform(prng.fold_in(key, 7), (n_edges,)) < p_arrive
            buf_c, buf_m = state.edge_counts.clone(), state.edge_mass.clone()
            hit = torch.zeros_like(state.edge_valid)
            for g0 in range(0, n_edges, n_buf):
                got = delivered[g0:g0 + n_buf]
                k = got.shape[0]
                buf_c[:k] = torch.where(got[:, None], counts_s[g0:g0 + k], buf_c[:k])
                buf_m[:k] = torch.where(got, mass_s[g0:g0 + k], buf_m[:k])
                hit[:k] |= got
            age = torch.where(hit, torch.zeros_like(state.edge_age), state.edge_age + 1)
            valid = state.edge_valid | hit
            weights = staleness_weights(age, params.staleness_decay, valid)
            counts_root, mass_root = _root_merge(cfg, buf_c, buf_m, weights)
            extra = dict(edge_counts=buf_c, edge_mass=buf_m, edge_age=age, edge_valid=valid)
        else:
            counts_root, mass_root = _root_merge(cfg, counts_s, mass_s, None)
        b_vec = ctx.pipeline.compressor.b_vector(d, state.b.b)
        theta = server.finalize_weighted(counts_root, mass_root, b_vec)
    with record_function("round.finish"):
        b_new = update_b_from_vote(state.b, vote, cfg.bctrl)
        new_state = dataclasses.replace(state, w_global=state.w_global + theta, w_locals=w_locals, b=b_new,
                                        residuals=residuals, **extra)
        recip = torch.reciprocal(wsum.clamp(min=1.0))
        metrics = {
            "loss": loss * recip,
            "b": b_new.b,
            "theta_mse": mean_rows((theta - dsum * recip) ** 2),
            "edge_mass_min": mass_f.min(),
            "theta": theta,
        }
        if n_buf:
            n_valid = valid.float().sum()
            metrics["buf_fill"] = n_valid * recip32(n_buf)
            metrics["mean_age"] = (age.float() * valid).sum() / n_valid.clamp(min=1.0)
    return new_state, metrics
