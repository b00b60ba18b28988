"""Packed one-bit wire over a real model parameter tree (per leaf).

Counterpart of ``repro/fl/pytree_wire.py``: the bridge between the
flat-vector FL engine (``fl/rounds.py`` runs raveled ``(M, d)`` cohorts)
and the model zoo. It runs the full ``ClientCompressor`` /
``ServerAggregator`` protocol (EF residual add -> top-k -> Eq.-5
stochastic binarize -> uint8 bit pack -> count accumulate -> Eq.-13 ML
estimate) **per parameter leaf** of a tree, so a transformer trains through
exactly the wire the paper analyzes.

Wire format: each leaf ``l`` (:mod:`repro_torch.tree` flatten order, the
reference's) is flattened to ``(M, d_l)`` and compressed on its own into a
:class:`~repro_torch.core.aggregation.PackedWire` (a
:class:`~repro_torch.core.aggregation.SparseWire` on the top-k wire).
Leaves are never concatenated.

Key schedule: leaf ``l`` uses the quantizer key ``fold_in(round_key, l)``
(:func:`leaf_key`); inside a leaf, client ``g`` draws chunk ``j`` from
``fold_in(fold_in(leaf_key, g), j)``. The draws depend only on ``(l, g,
j)``, so client chunking (``row_offset``), the order of the leaves and a
per-leaf dense reference all give the same bits, and the port's wire is the
reference's byte for byte.

With ``use_kernels`` on the card a leaf's cohort goes through the pack
kernel (B1, or B2 with error feedback) and its estimate through the count
kernel (B3); the streamed form folds chunk counts with the plain int32
count and finalizes with the plain Eq.-13 estimate, as the reference's
does, which B3 equals bit for bit.

Counts accumulate in int32 (f32 when weighted): a uint8 accumulator would
wrap past 255 clients.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import prng
from ..core.aggregation import AggregatorPipeline
from ..core.quantizer import wire_bytes as _wire_row_bytes
from ..tree import leaves, tree_map, unflatten

__all__ = [
    "PytreeWireState",
    "leaf_key",
    "init_wire_state",
    "pytree_wire_bytes",
    "compress_pytree",
    "aggregate_pytree",
    "stream_aggregate_pytree",
]


def leaf_key(key: torch.Tensor, leaf_index: int) -> torch.Tensor:
    """Quantizer key of parameter leaf ``leaf_index`` (flatten order): the
    one fold level on top of the flat-vector schedule that every path
    compressing leaf ``l`` derives its client keys from."""
    return prng.fold_in(key, leaf_index)


@dataclasses.dataclass(frozen=True)
class PytreeWireState:
    """Per-parameter compressor state (the EF 'optimizer buffer' tree)."""

    residuals: Any  # tree matching params, leaves (M, *leaf_shape) f32


def init_wire_state(params: Any, m: int) -> PytreeWireState:
    """Zero EF residuals for an ``m``-client cohort over ``params``."""
    return PytreeWireState(
        residuals=tree_map(lambda w: torch.zeros((m,) + tuple(w.shape), dtype=torch.float32, device=w.device), params)
    )


def pytree_wire_bytes(pipeline: AggregatorPipeline, params: Any, m: int) -> dict[str, int]:
    """Uplink bytes of an ``m``-client round over ``params``, per format.

    ``wire_bytes`` is what travels (packed rows with the pad the compressor
    emits); ``wire_bytes_ideal`` the unpadded ``ceil(d_l/8)`` floor;
    ``int8`` / ``f32`` the quantized and full-precision baselines. Dense
    (FedAvg) pipelines ship f32 for every leaf.
    """
    comp = pipeline.compressor
    bits = comp.wire_bits
    packed = ideal = dim = 0
    for leaf in leaves(params):
        d = leaf.numel()
        wb = comp.wire_bytes(d)
        if comp.mode != "dense" and comp.topk_frac < 1.0:
            # int32 indices + packed codes; no padding on the sparse wire
            sparse = _wire_row_bytes(d, bits, topk_frac=comp.topk_frac)
            packed += sparse
            ideal += sparse
        else:
            packed += wb if wb is not None else 4 * d
            ideal += _wire_row_bytes(d, bits) if wb is not None else 4 * d
        dim += d
    return {
        "wire_bytes": m * packed,
        "wire_bytes_ideal": m * ideal,
        "wire_bytes_int8": m * dim,
        "wire_bytes_f32": m * 4 * dim,
    }


def compress_pytree(
    pipeline: AggregatorPipeline,
    key: torch.Tensor,
    deltas: Any,
    b_scalar: torch.Tensor,
    state: PytreeWireState,
    *,
    row_offset: int = 0,
) -> tuple[list, PytreeWireState]:
    """Client half per leaf: ``(M, *shape)`` deltas -> one wire a leaf, in
    flatten order, and the advanced EF state. ``row_offset`` rebases cohort
    positions: clients compressed at offset ``g0`` emit the rows ``[g0,
    g0 + M)`` of a one-shot compress."""
    d_leaves = leaves(deltas)
    m = d_leaves[0].shape[0]
    wires, new_res = [], []
    for i, (dl, rl) in enumerate(zip(d_leaves, leaves(state.residuals))):
        d = dl[0].numel()
        wire, r_new = pipeline.compressor.compress(
            leaf_key(key, i), dl.reshape(m, d).float(), b_scalar, rl.reshape(m, d).float(), row_offset=row_offset
        )
        wires.append(wire)
        new_res.append(r_new.reshape(rl.shape))
    return wires, PytreeWireState(residuals=unflatten(deltas, new_res))


def aggregate_pytree(
    pipeline: AggregatorPipeline,
    key: torch.Tensor,
    deltas: Any,
    b_scalar: torch.Tensor,
    state: PytreeWireState,
    *,
    weights: torch.Tensor | None = None,
) -> tuple[Any, PytreeWireState]:
    """One-shot round over a tree: compress every leaf, estimate theta.
    Returns ``(theta_tree, state')``, theta leaves shaped like the
    parameters; ``weights`` (one a client) selects the weighted counts."""
    wires, new_state = compress_pytree(pipeline, key, deltas, b_scalar, state)
    thetas = [pipeline.estimate(w, weights).reshape(dl.shape[1:]) for w, dl in zip(wires, leaves(deltas))]
    return unflatten(deltas, thetas), new_state


def stream_aggregate_pytree(
    pipeline: AggregatorPipeline,
    key: torch.Tensor,
    deltas: Any,
    b_scalar: torch.Tensor,
    state: PytreeWireState,
    *,
    client_chunk: int,
) -> tuple[Any, PytreeWireState]:
    """Client-streamed round: each leaf folds its cohort ``client_chunk``
    clients at a time through ``init_counts -> accumulate_counts ->
    finalize`` (a Python loop over chunks, each compressed at its
    ``row_offset``), so only ``client_chunk`` rows of wire are resident.
    Integer counts add exactly and the draws depend only on the cohort
    position, so the result equals :func:`aggregate_pytree` bit for bit for
    every count scheme (PRoBit+, signSGD-MV, RSA); EF residuals advance
    chunk by chunk. Top-k and per-client widths do not count-stream."""
    comp, server = pipeline.compressor, pipeline.server
    if server.stream_kind != "counts":
        raise ValueError(
            f"{type(server).__name__} (stream_kind={server.stream_kind!r}) cannot client-stream; use aggregate_pytree"
        )
    if comp.topk_frac < 1.0:
        raise ValueError("top-k sparse wires cannot count-stream")
    if comp.client_bits is not None:
        raise ValueError(
            "per-client bit-widths emit a per-group HeteroWire and cannot fold through the flat count "
            "accumulator; use aggregate_pytree"
        )
    d_leaves = leaves(deltas)
    m = d_leaves[0].shape[0]
    if m % client_chunk:
        raise ValueError(f"cohort size {m} not divisible by client_chunk {client_chunk}")
    thetas, new_res = [], []
    for i, (dl, rl) in enumerate(zip(d_leaves, leaves(state.residuals))):
        d = dl[0].numel()
        d2, r2 = dl.reshape(m, d).float(), rl.reshape(m, d).float()
        lk = leaf_key(key, i)
        counts = server.init_counts(comp.wire_bytes(d), dl.device)
        res_buf = r2.clone()
        for g0 in range(0, m, client_chunk):
            wire, r_new = comp.compress(lk, d2[g0 : g0 + client_chunk], b_scalar, res_buf[g0 : g0 + client_chunk],
                                        row_offset=g0)
            counts = server.accumulate_counts(counts, wire.packed)
            res_buf[g0 : g0 + client_chunk] = r_new
        thetas.append(server.finalize(counts, m, comp.b_vector(d, b_scalar)).reshape(dl.shape[1:]))
        new_res.append(res_buf.reshape(rl.shape))
    return unflatten(deltas, thetas), PytreeWireState(residuals=unflatten(deltas, new_res))
