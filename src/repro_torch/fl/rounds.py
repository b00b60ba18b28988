"""FL rounds (paper Algorithm 1) as state -> state.

Counterpart of ``repro/fl/rounds.py``: the synchronous round
(:func:`fl_round`), the same round streamed over chunks of clients
(:func:`stream_fl_round`) and the buffered-asynchronous round
(:func:`async_fl_round`), with the reference's key schedule, so at a fixed
seed the port draws the reference's client batches and quantizer bits:

* client ``m``'s batch indices: ``randint(fold_in(kb, m), (steps, batch))``;
* the active cohort under partial participation:
  ``sel = choice(fold_in(kr, 99), n_clients, (n_active,))``;
* attack and quantizer keys: ``k_att, k_q = split(fold_in(kr, 1))``;
* client ``i``'s uniforms: chunk ``j`` from ``fold_in(fold_in(k_q, i), j)``.

The round runs in five steps: every active client trains from its
personal model, prox-regularized toward the global one (the ``prox_sgd``
kernel); the deltas pass through the delta-level attack, whose Byzantines
are the first ``int(n_active * byz_frac)`` rows of the active cohort; the
compressor puts them on the wire (PRoBit+: ``stoch_quant_pack`` or, with
error feedback, ``stoch_quant_ef``); the server estimates theta_hat
(PRoBit+: ``bit_aggregate``); the global model steps, the b-controller
votes and the active clients' state is written back at ``sel``.

The streaming round (``client_chunk = C > 0``) runs the same protocol a
chunk of C clients at a time: each chunk draws its own clients' batches,
trains, attacks and compresses them (quantizer rows keyed by cohort
position, so the bits are the dense round's), and folds them into additive
carries (the server's vote counts, FedAvg's weighted sum or Fed-GM's row
buffer, the b-vote, loss and delta sums, the weight sum). Only one chunk's
(C, d) planes exist at a time. When C does not divide the cohort, the last
chunk's pad rows wrap onto earlier clients, weigh 0 and are not written
back. ``stateless_clients`` trains every client from the global model and
keeps no per-client state. For the count schemes the streamed round equals
the dense one exactly; FedAvg and Fed-GM sum in another order.

The asynchronous round (``async_buffer = B > 0``) keeps the last B
delivered wire rows: client ``m`` delivers with probability
``1 / (1 + latency)`` (uniform ``fold_in(key, 7)``) into slot ``m mod B``,
later clients winning a shared slot; the server estimates from the buffer
with staleness weights ``(1 + age) ** -decay``; the ``straggler`` attack
makes each Byzantine deliver only while no Byzantine upload sits in its
slot. At ``B = M``, zero latency and zero decay it equals
:func:`fl_round` bit for bit.

A masked context (a fused heterogeneous-M campaign group, ``masked=True``)
pads the client axis to the group's largest cohort; the run's own cohort
``CellParams.m_active`` enters as a 0/1 row mask (:func:`client_mask`) on
the weighted count path of the estimate, on the b-vote and on the metric
means, so one context serves every M of the group. :func:`fl_round`,
:func:`stream_fl_round`, :func:`async_fl_round` and the tree's round
also take a group of E runs at once, on every wire, with a leading E on
the keys, the state and the batches: each kernel is launched once a step
(a streamed round or a tree's edge: once a chunk's step) for the group,
and each run's draws, gates and float sums are its own. A sharded cohort
(``stream_shard``) sums each carry of the whole group over the ranks in
one collective. :func:`run_rounds` runs ``rounds`` rounds on
``FLSimulation``'s key schedule and returns the final state and each
metric's trajectory; the campaign engine (:mod:`repro_torch.sim`) runs
every group through it as one group.

Each step runs under a ``torch.profiler.record_function`` range
(``round.batches``, ``round.sample`` under partial participation,
``round.local_train``, ``round.compress``,
``round.estimate``, ``round.finish``; the streaming round's steps nest in
one ``round.chunk`` range a chunk), so a profiler trace splits a
round's device time by step; with no profiler active a range costs a few
microseconds of host time.

The hierarchical tree round (:mod:`repro_torch.fl.hierarchy`,
``tree_edges = E > 0``) runs this chunk loop over E contiguous slices of
the cohort and merges the slices' count tensors at a root;
:func:`round_fn` and :func:`init_run_state` pick it. Every round takes
the k-bit, mixed-width and top-k wires wherever the config admits them.

``stream_shard`` spreads the streamed cohort over the ranks of the client
group (:func:`repro_torch.distributed.client_group`): rank ``k`` holds only
its contiguous block of ``n_active / n`` clients' data and scans it, and the
additive carries are summed over the ranks, the reference's ``psum``. The
count, vote and weight sums are integers, so the estimate, the new model
and b are the unsharded round's bit for bit; the chunks' loss sums cross
ranks as they are and are added in chunk order, so the loss is too. Only
the delta sum behind ``theta_mse`` reassociates. With no process group,
or a world of one, the round warns (the reference's one-device no-op) and
runs unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from .. import distributed, prng
from ..core import (
    BState,
    DenseWire,
    apply_attack,
    apply_attack_stream,
    attack_id,
    init_b_state,
    is_timing_attack,
    is_wire_attack,
    loss_bit,
    staleness_weights,
    update_b,
    update_b_from_vote,
)
from ..core.aggregation import mean_rows, recip32
from ..interop import ravel_params
from ..optim import local_prox_train

__all__ = [
    "RoundState",
    "AsyncRoundState",
    "CellParams",
    "RoundContext",
    "make_context",
    "init_state",
    "init_async_state",
    "init_run_state",
    "cell_params",
    "client_mask",
    "round_batches",
    "fl_round",
    "stream_fl_round",
    "async_fl_round",
    "round_fn",
    "evaluate",
    "run_rounds",
]


@dataclasses.dataclass(frozen=True)
class RoundState:
    """Evolving state of one FL run (tensors on the run's device)."""

    w_global: torch.Tensor  # (d,)
    w_locals: torch.Tensor  # (n_clients, d) personal models; (1, d) when stateless
    b: BState  # dynamic-b controller state
    residuals: torch.Tensor  # (n_clients, d) error-feedback residuals; (1, d) when stateless


@dataclasses.dataclass(frozen=True, kw_only=True)
class AsyncRoundState(RoundState):
    """A buffered-asynchronous run's state: the synchronous fields and the
    server's buffer of the last ``B`` delivered wire rows."""

    buf_rows: torch.Tensor  # (B, P) uint8 packed rows, or (B, d) f32 dense
    buf_age: torch.Tensor  # (B,) int32 rounds since the slot's upload arrived
    buf_valid: torch.Tensor  # (B,) bool: the slot holds an upload
    buf_owner: torch.Tensor  # (B,) int32 client that wrote the slot, -1 before any


@dataclasses.dataclass(frozen=True)
class CellParams:
    """Per-run scenario knobs: the fields that may differ between the runs
    of one campaign group (and so cannot come from the group's shared
    ``ctx.cfg``). Python scalars for one run (:func:`cell_params`); numpy
    arrays ``(E,)`` for the E runs of a batched group
    (``repro_torch.sim.campaign._batched_inputs``)."""

    lr: Any
    momentum: Any
    lam: Any
    attack_id: Any  # index into repro_torch.core.ATTACK_IDS (delta stage)
    flip_gate: Any  # bool: arm the bit_flip wire adversary (needs ctx.flip_n > 0)
    latency: Any  # mean upload latency in rounds; P(arrive) = 1 / (1 + latency)
    staleness_decay: Any  # age-weight exponent: w(age) = (1 + age) ** -decay
    straggler_gate: Any  # bool: arm the straggler timing adversary
    # The run's real cohort; read only by a masked context, whose client
    # axis is padded to the group's largest (rows >= m_active are masked out
    # of the estimate, the b-vote and the metrics).
    m_active: Any = None


@dataclasses.dataclass(frozen=True)
class RoundContext:
    """Everything a round closes over: config, task, data, pipeline."""

    cfg: Any  # FLConfig
    loss_fn: Callable  # loss_fn(params, {"x", "y"}) -> per-client losses
    acc_fn: Callable
    unravel: Callable
    pipeline: Any  # repro_torch.core.AggregatorPipeline
    w0: torch.Tensor  # (d,) flat initial parameters
    client_x: torch.Tensor  # (n_clients, per_client, ...)
    client_y: torch.Tensor  # (n_clients, per_client)
    test: dict
    flip_n: int  # rows bit-flipped on the wire when a run's flip_gate is on
    device: torch.device
    engine: str | None = None  # kernel engine passed to ops (None: by device)
    # A fused heterogeneous-M campaign group's context: cfg.n_clients is the
    # group's largest cohort and each run's own is CellParams.m_active.
    masked: bool = False
    # The process group a sharded context (stream_shard, tree_shard) spreads
    # its clients over, None unsharded; client_x and client_y then hold this
    # rank's block of clients, the first of which is client data_offset.
    group: Any = None
    data_offset: int = 0

    @property
    def d(self) -> int:
        return self.w0.shape[0]


def _to(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def make_context(
    cfg,
    init_params,
    loss_fn: Callable,
    acc_fn: Callable,
    client_x,
    client_y,
    test: dict,
    *,
    device,
    engine: str | None = None,
    wire_flip: bool | None = None,
    masked: bool = False,
) -> RoundContext:
    """Resolve a config and a task into a RoundContext on ``device``.

    ``init_params`` is a (nested) dict of arrays in the reference's layout;
    ``engine`` forces the kernel engine of every ``ops`` call (``"ref"``
    runs the plain versions on the card). ``wire_flip`` arms the bit_flip
    slot (``flip_n``) even when ``cfg.attack`` is not bit_flip: a campaign
    group sets it when any of its cells is one, and each run's
    ``flip_gate`` selects. ``masked`` marks a fused heterogeneous-M
    context (``cfg.n_clients`` is the group's largest cohort), which needs
    synchronous rounds at full participation.
    """
    if masked and (cfg.async_buffer or cfg.participation < 1.0):
        raise ValueError(
            "masked (fused heterogeneous-M) contexts require synchronous rounds at full participation; "
            "see repro_torch.sim.plan.fusable"
        )
    device = torch.device(device)
    w0, unravel = ravel_params(init_params, device)
    n_byz = int(cfg.n_active * cfg.byz_frac)
    if wire_flip is None:
        wire_flip = is_wire_attack(cfg.attack)
    group, offset = _shard_layout(cfg)
    if group is not None:
        block = cfg.n_active // distributed.group_size(group)
        client_x, client_y = client_x[offset:offset + block], client_y[offset:offset + block]
    return RoundContext(
        cfg=cfg,
        loss_fn=loss_fn,
        acc_fn=acc_fn,
        unravel=unravel,
        pipeline=cfg.pipeline(engine=engine),
        w0=w0,
        client_x=_to(client_x, device).float(),
        client_y=_to(client_y, device).long(),
        test={k: _to(v, device) for k, v in test.items()},
        flip_n=n_byz if wire_flip else 0,
        device=device,
        engine=engine,
        masked=masked,
        group=group,
        data_offset=offset,
    )


def _shard_layout(cfg):
    """The client group a ``stream_shard`` or ``tree_shard`` config spreads
    over and the first client of this rank's block: ``(None, 0)`` when it
    runs unsharded, which with no group or a world of one is the
    reference's one-device no-op and warns, and when the cohort (the
    edges) does not divide over the ranks, the reference's fallback, which
    warns too."""
    import warnings

    if not (cfg.stream_shard or cfg.tree_shard):
        return None, 0
    name, units = ("stream_shard", cfg.n_active) if cfg.stream_shard else ("tree_shard", cfg.tree_edges)
    group = distributed.client_group()
    n = distributed.group_size(group)
    if n <= 1:
        warnings.warn(
            f"{name} is a no-op: only one local device is visible. Start several ranks "
            "(torchrun --nproc-per-node N) to shard it.",
            RuntimeWarning,
            stacklevel=3,
        )
        return None, 0
    if units % n:
        if cfg.stream_shard:
            msg = f"stream_shard falling back to a single-device scan: cohort size {units} does not divide across"
        else:
            msg = f"tree_shard falling back to a host-loop edge sweep: {units} edges do not divide across"
        warnings.warn(f"{msg} {n} devices.", RuntimeWarning, stacklevel=3)
        return None, 0
    return group, distributed.group_rank(group) * (cfg.n_active // n)


def init_state(ctx: RoundContext, b_init=None) -> RoundState:
    """Fresh run state; ``b_init`` overrides the config's initial b (a
    campaign cell's own). ``stateless_clients`` keeps one broadcast row of
    each per-client plane, which no round reads."""
    cfg = ctx.cfg
    n_rows = 1 if cfg.stateless_clients else cfg.n_clients
    b = init_b_state(cfg.bctrl if b_init is None else dataclasses.replace(cfg.bctrl, init=b_init), ctx.device)
    return RoundState(
        w_global=ctx.w0,
        w_locals=ctx.w0.unsqueeze(0).repeat(n_rows, 1),
        b=b,
        residuals=torch.zeros((n_rows, ctx.d), dtype=torch.float32, device=ctx.device),
    )


def init_async_state(ctx: RoundContext, b_init=None) -> AsyncRoundState:
    """Fresh asynchronous run state: the synchronous fields and an empty
    buffer of ``async_buffer`` rows in the wire's format (packed uint8 rows
    of the compressor's width, dense f32 rows for FedAvg and Fed-GM)."""
    n_buf, dev = ctx.cfg.async_buffer, ctx.device
    n_bytes = ctx.pipeline.compressor.wire_bytes(ctx.d)
    if n_bytes is None:
        rows = torch.zeros((n_buf, ctx.d), dtype=torch.float32, device=dev)
    else:
        rows = torch.zeros((n_buf, n_bytes), dtype=torch.uint8, device=dev)
    return AsyncRoundState(
        **vars(init_state(ctx, b_init)),
        buf_rows=rows,
        buf_age=torch.zeros(n_buf, dtype=torch.int32, device=dev),
        buf_valid=torch.zeros(n_buf, dtype=torch.bool, device=dev),
        buf_owner=torch.full((n_buf,), -1, dtype=torch.int32, device=dev),
    )


def init_run_state(ctx: RoundContext, b_init=None) -> RoundState:
    """The state the config calls for: asynchronous, a buffered tree's
    (:func:`repro_torch.fl.hierarchy.init_tree_state`) or synchronous."""
    if ctx.cfg.async_buffer:
        return init_async_state(ctx, b_init)
    if ctx.cfg.tree_edges and ctx.cfg.edge_buffer:
        from .hierarchy import init_tree_state

        return init_tree_state(ctx, b_init)
    return init_state(ctx, b_init)


def round_fn(ctx: RoundContext) -> Callable:
    """The round function of the config: asynchronous, a tree's
    (:func:`repro_torch.fl.hierarchy.tree_fl_round`), streamed or dense."""
    if ctx.cfg.async_buffer:
        return async_fl_round
    if ctx.cfg.tree_edges:
        from .hierarchy import tree_fl_round

        return tree_fl_round
    if ctx.cfg.client_chunk:
        return stream_fl_round
    return fl_round


def cell_params(cfg) -> CellParams:
    """The CellParams one FLConfig describes (scalars)."""
    return CellParams(
        lr=cfg.lr,
        momentum=cfg.momentum,
        lam=cfg.lam,
        attack_id=attack_id(cfg.attack),
        flip_gate=is_wire_attack(cfg.attack),
        latency=cfg.async_latency,
        staleness_decay=cfg.staleness_decay,
        straggler_gate=is_timing_attack(cfg.attack),
        m_active=cfg.n_active,
    )


def client_mask(ctx: RoundContext, params: CellParams) -> torch.Tensor | None:
    """The 0/1 f32 active-client row mask of a masked context (rows below
    the run's ``m_active``; (E, n) rows for a group whose ``m_active`` is
    an (E,) tensor); None for an unmasked one, whose estimate, b-vote and
    metric means stay the exact unweighted ones."""
    if not ctx.masked:
        return None
    rows = torch.arange(ctx.cfg.n_active, device=ctx.device)
    m = params.m_active
    return (rows < (m.unsqueeze(-1) if torch.is_tensor(m) else int(m))).float()


def _batch_steps(ctx: RoundContext) -> int:
    cfg = ctx.cfg
    return max(cfg.local_epochs * ctx.client_x.shape[1] // cfg.batch_size, 1)


def _client_batch_idx(ctx: RoundContext, key: torch.Tensor, client_ids: torch.Tensor) -> torch.Tensor:
    """Batch indices (n, steps, batch) of the given clients, each keyed by
    ``fold_in(key, client_id)`` as in the reference."""
    keys = prng.fold_in(key, client_ids)
    return prng.randint(keys, (_batch_steps(ctx), ctx.cfg.batch_size), 0, ctx.client_x.shape[1])


def _gather_batches(ctx: RoundContext, key: torch.Tensor, ids: torch.Tensor, data=None) -> dict:
    """The batches of clients ``ids`` (C,); for a group, keys (E, 2) and ids
    (E, C), each run's from its own key (and, with a fused group's
    ``data``, its own cell's rows): leaves ``(E, C, steps, batch, ...)``."""
    if key.dim() == 1:
        idx = _client_batch_idx(ctx, key, ids)
        rows = (ids - ctx.data_offset).view(-1, 1, 1)
        return {"x": ctx.client_x[rows, idx], "y": ctx.client_y[rows, idx]}
    idx = _client_batch_idx(ctx, key.unsqueeze(-2), ids)
    rows = (ids - ctx.data_offset).view(ids.shape + (1, 1))
    if data is None:
        return {"x": ctx.client_x[rows, idx], "y": ctx.client_y[rows, idx]}
    cell = data.data_idx.view(-1, 1, 1, 1)
    return {"x": data.client_x[cell, rows, idx], "y": data.client_y[cell, rows, idx]}


def round_batches(ctx: RoundContext, key: torch.Tensor, data=None) -> dict:
    """One round's local-training batches of every client:
    ``{"x": (n, steps, batch, ...), "y": (n, steps, batch)}``, with a
    leading E for a group's keys (E, 2). ``data`` is a fused group's client
    data (``repro_torch.sim.batched.GroupData``): each run reads its own
    cell's rows. A streaming round draws each chunk's batches itself and
    gets ``{"key": key}`` (and a fused group's ``"data"``)."""
    if ctx.cfg.client_chunk:
        return {"key": key} if data is None else {"key": key, "data": data}
    with record_function("round.batches"):
        ids = torch.arange(ctx.cfg.n_clients, dtype=torch.int64, device=ctx.device)
        idx = _client_batch_idx(ctx, key.unsqueeze(-2), ids)
        rows = ids.view(-1, 1, 1)
        if data is None:
            return {"x": ctx.client_x[rows, idx], "y": ctx.client_y[rows, idx]}
        cell = data.data_idx.view(-1, 1, 1, 1)
        return {"x": data.client_x[cell, rows, idx], "y": data.client_y[cell, rows, idx]}


def _client_uploads(ctx, params, key, state, batches):
    """The client side of a round: participation sampling, local
    prox-training, delta attack, and compression onto the wire.

    ``key`` is (2,) for one run, or (E, 2) for a group of E runs whose
    state and batches carry the same leading E and whose ``params`` hold
    one value a run. Returns ``sel``, the active rows' indices into the
    (E * n_clients, d) view of the client planes (None at full
    participation), the trained rows ``w_new`` (E * n_active, d) and their
    losses before and after training, and the attacked deltas, the wire
    and the new residuals with the key's leading axes."""
    cfg, d = ctx.cfg, ctx.d
    lead = tuple(key.shape[:-1])
    m, n = cfg.n_clients, cfg.n_active
    w_sel, res_sel, sel = state.w_locals.reshape(-1, d), state.residuals.reshape(-1, d), None
    batches = {k: v.flatten(0, len(lead)) for k, v in batches.items()}
    if cfg.participation < 1.0:
        with record_function("round.sample"):
            # each run draws its own cohort from its own key
            sels = [prng.choice(prng.fold_in(k, 99), m, (n,)) for k in key.view(-1, 2)]
            sel = sels[0] if len(sels) == 1 else torch.cat([s + i * m for i, s in enumerate(sels)])
            w_sel, res_sel = w_sel.index_select(0, sel), res_sel.index_select(0, sel)
            batches = {k: v.index_select(0, sel) for k, v in batches.items()}
    with record_function("round.local_train"):
        w_new, loss_before, loss_after = local_prox_train(
            ctx.loss_fn, state.w_global, w_sel, ctx.unravel, batches,
            lr=params.lr, mu=params.momentum, lam=params.lam,
            use_kernel=cfg.use_kernels, engine=ctx.engine,
        )
    with record_function("round.compress"):
        deltas = w_new.view(lead + (n, d)) - state.w_global.unsqueeze(-2)
        k_att, k_q = prng.split(prng.fold_in(key, 1), 2).unbind(-2)
        deltas_att = _attack(params.attack_id, k_att, deltas, int(n * cfg.byz_frac))
        wire, res_new = ctx.pipeline.compress_wire(
            k_q, deltas_att, state.b.b, res_sel.view(lead + (n, d)), flip_n=ctx.flip_n, flip_gate=params.flip_gate
        )
    return sel, w_new, loss_before, loss_after, deltas_att, wire, res_new


def _attack(attack_id, k_att, deltas, n_byz):
    """The delta-level attack on one run's (n, d) deltas, or on each run's
    own rows of a group's (E, n, d), with the run's own id and key (written
    into ``deltas``)."""
    if deltas.dim() == 2:
        return apply_attack(attack_id, k_att, deltas, n_byz)
    for i, rows in enumerate(deltas):
        attacked = apply_attack(int(attack_id[i]), k_att[i], rows, n_byz)
        if attacked is not rows:
            rows.copy_(attacked)
    return deltas


def _finish_round(ctx, state, w_new, loss_before, loss_after, res_new, theta, deltas_att, sel=None, mask=None,
                  **extra):
    """Server epilogue: global step, b-control, write-back of the active
    clients' state at ``sel`` (all clients when None), metrics; for one run
    or, with a leading E on ``theta`` and the state, for a group (the
    shapes of :func:`_client_uploads`). ``mask`` (a masked context's
    active-client rows) keeps padded clients out of the b-vote and the loss
    and theta_mse means, which then multiply by the f32 reciprocal of the
    mask's sum. ``extra`` replaces further fields of the state (the
    asynchronous buffer)."""
    cfg, d = ctx.cfg, ctx.d
    bits = loss_bit(loss_before, loss_after).view(theta.shape[:-1] + (-1,))
    b_new = update_b(state.b, bits, cfg.bctrl, weights=mask)
    if sel is None:
        w_new = w_new.view(state.w_locals.shape)
    else:
        w_new = state.w_locals.reshape(-1, d).index_copy(0, sel, w_new).view(state.w_locals.shape)
        res_new = state.residuals.reshape(-1, d).index_copy(0, sel, res_new.reshape(-1, d)).view(state.residuals.shape)
    new_state = dataclasses.replace(
        state, w_global=state.w_global + theta, w_locals=w_new, b=b_new, residuals=res_new, **extra
    )
    loss, theta_mse = round_metrics(loss_after, deltas_att, theta, mask)
    return new_state, {"loss": loss, "b": b_new.b, "theta_mse": theta_mse, "theta": theta}


def round_metrics(loss_after, deltas_att, theta, mask=None):
    """A round's ``loss`` (the mean post-training local loss) and
    ``theta_mse`` (theta_hat's squared error against the mean uploaded
    update); ``mask`` keeps a masked context's padded clients out of both
    means, which then multiply by the f32 reciprocal of its sum. A group's
    (E, d) ``theta`` gives (E,) metrics, each run's means taken on its own
    rows: on the card a reduction over one axis of (E, n) rounds otherwise
    than one over (n,) (ROADMAP C)."""
    if theta.dim() == 2:
        e = theta.shape[0]
        per_run = [round_metrics(loss_after.view(e, -1)[i], deltas_att[i], theta[i], None if mask is None else mask[i])
                   for i in range(e)]
        return tuple(torch.stack(values) for values in zip(*per_run))
    if mask is None:
        loss, delta_mean = mean_rows(loss_after), mean_rows(deltas_att)
    else:
        recip = torch.reciprocal(mask.sum().clamp(min=1.0))
        loss, delta_mean = (loss_after * mask).sum() * recip, (deltas_att * mask[:, None]).sum(0) * recip
    return loss, mean_rows((theta - delta_mean) ** 2)


def fl_round(
    ctx: RoundContext, params: CellParams, key: torch.Tensor, state: RoundState, batches: dict
) -> tuple[RoundState, dict]:
    """One FL round: local prox-training, attack, aggregate, b-control.

    Returns the next state and the round's metrics as tensors: ``loss``
    (mean post-training local loss), ``b`` (after the vote),
    ``theta_mse`` (squared error of theta_hat against the mean uploaded
    update, the aggregation error Theorem 1 bounds) and ``theta``, the
    (d,) estimate itself. Under a masked context the active-client mask
    weighs the vote counts (``N_i^w`` counts real clients only and
    ``M^w = m_active``), the b-vote and the means.

    A group of E runs (a campaign group, ``repro_torch.sim``) passes keys
    (E, 2), a state and batches with a leading E, and ``params`` holding
    one value a run (``lr``, ``momentum`` and ``lam`` as (E,) f32 tensors
    on the device, ``m_active`` too under a masked context): each kernel
    is launched once a step for the whole group, and the metrics are (E,).
    Each run's values are its own single round's bit for bit: its draws
    are the same function of its key, each kernel computes a run's rows as
    it computes one run's, and the model's forward and backward, the
    attacks and the metric means run on each run's own rows.
    """
    sel, w_new, loss_before, loss_after, deltas_att, wire, res_new = _client_uploads(
        ctx, params, key, state, batches
    )
    mask = client_mask(ctx, params)
    with record_function("round.estimate"):
        theta = ctx.pipeline.estimate(wire, weights=mask)
    with record_function("round.finish"):
        return _finish_round(ctx, state, w_new, loss_before, loss_after, res_new, theta, deltas_att, sel, mask)


def _stream_chunks(ctx, params, kb, k_att, k_q, state, sel, n_byz, weighted, limit, *, row0=0, planes=None,
                   data=None):
    """The streaming round's chunk loop over the cohort rows ``sel``, the
    first of which is cohort position ``row0`` (a tree's edge passes its
    slice of the cohort): every chunk of ``cfg.client_chunk`` rows trains,
    attacks and compresses, keyed by cohort position, and folds into the
    additive carries, where positions at or past ``limit`` weigh 0.
    ``planes`` are the (w_locals, residuals) an earlier slice of the same
    round wrote back; None starts from the state's own, copied before the
    first write. Returns the carries, the loss as each chunk's own sum (add
    them with :func:`_add_in_order`), with the written-back planes (the
    state's own when stateless).

    A group of E runs passes keys (E, 2), ``sel`` (E, n), a state with a
    leading E, ``params`` one value a run (``limit`` an (E,) tensor under a
    masked context) and a fused group's ``data``: every carry then has a
    leading E, each chunk launches each kernel once for the group, and each
    run's float sums are taken on its own rows."""
    cfg, d, dev = ctx.cfg, ctx.d, ctx.device
    C, n = cfg.client_chunk, sel.shape[-1]
    lead = tuple(kb.shape[:-1])
    e = lead[0] if lead else None
    server = ctx.pipeline.server
    kind = server.stream_kind
    n_pad = -(-n // C) * C
    # pad rows wrap onto earlier clients; they weigh 0 and are not written back
    sel_p = sel[..., torch.arange(n_pad, device=dev) % n]
    if kind == "counts":
        acc = server.init_counts(ctx.pipeline.compressor.wire_bytes(d), dev, weighted=weighted)
    elif kind == "sum":
        acc = server.init_stream_sum(d, dev)
    else:  # "buffer": Fed-GM reads every row in each Weiszfeld step
        acc = torch.empty(lead + (n_pad, d), dtype=torch.float32, device=dev)
    if lead and kind != "buffer":
        acc = tuple(a.repeat(lead + (1,) * a.dim()) for a in acc) if kind == "sum" else acc.repeat(e, 1)
    zero = torch.zeros(lead, device=dev)
    vote, wsum, dsum, losses = zero, zero, torch.zeros(lead + (d,), device=dev), []
    if planes is not None:
        w_locals, residuals = planes
    else:
        w_locals, residuals = state.w_locals, state.residuals
        if not cfg.stateless_clients:
            w_locals = w_locals.clone()  # the incoming state stays as it was
    m_rows = state.w_locals.shape[-2]
    for g0 in range(0, n_pad, C):
        with record_function("round.chunk"):
            k = min(C, n - g0)  # real rows of the chunk, then pad rows
            sel_c = sel_p[..., g0:g0 + C]
            w_c = _chunk_weights(C, k, limit - row0 - g0, lead, dev)
            with record_function("round.batches"):
                batches = _gather_batches(ctx, kb, sel_c, data)
            if lead:
                batches = {name: v.flatten(0, 1) for name, v in batches.items()}
                # the chunk's rows in the (E * M, d) view of the client planes
                flat = (sel_c + torch.arange(e, device=dev).unsqueeze(-1) * m_rows).flatten()
            if cfg.stateless_clients:
                w_start = state.w_global.unsqueeze(-2).expand(lead + (C, d)).reshape(-1, d)
                res_c = torch.zeros((1, d), device=dev).expand(lead + (C, d))
            elif lead:
                w_start = w_locals.reshape(-1, d).index_select(0, flat)
                res_c = residuals.reshape(-1, d).index_select(0, flat).view(lead + (C, d))
            else:
                # gathered copies: training and compressing never write the planes
                w_start, res_c = w_locals.index_select(0, sel_c), residuals.index_select(0, sel_c)
            with record_function("round.local_train"):
                w_new, loss_before, loss_after = local_prox_train(
                    ctx.loss_fn, state.w_global, w_start, ctx.unravel, batches,
                    lr=params.lr, mu=params.momentum, lam=params.lam,
                    use_kernel=cfg.use_kernels, engine=ctx.engine,
                )
            with record_function("round.compress"):
                w_rows = w_new.view(lead + (C, d))
                deltas = _attack_stream(params.attack_id, k_att, w_rows - state.w_global.unsqueeze(-2) if lead
                                        else w_rows - state.w_global, n_byz, row0 + g0)
                wire, res_new = ctx.pipeline.compress_wire(
                    k_q, deltas, state.b.b, res_c, flip_n=ctx.flip_n, flip_gate=params.flip_gate,
                    row_offset=row0 + g0,
                )
                acc = _accumulate(server, kind, acc, wire, w_c if weighted or kind == "sum" else None, g0, lead)
                vote = vote + (loss_bit(loss_before, loss_after).float().view(lead + (C,)) * w_c).sum(-1)
                losses.append(_per_run(lambda la, wc: (la * wc).sum(), lead, loss_after.view(lead + (C,)), w_c))
                dsum = dsum + _per_run(lambda dl, wc: (dl * wc[:, None]).sum(0), lead, deltas, w_c)
                wsum = wsum + w_c.sum(-1)
                if not cfg.stateless_clients:
                    if lead:
                        rows = flat.view(lead + (C,))[:, :k].flatten()
                        w_locals.view(-1, d).index_copy_(0, rows, w_new.view(lead + (C, d))[:, :k].reshape(-1, d))
                    else:
                        w_locals.index_copy_(0, sel_c[:k], w_new[:k])
                    if res_new is not res_c:  # error feedback changed them
                        if residuals is state.residuals:
                            residuals = residuals.clone()
                        if lead:
                            residuals.view(-1, d).index_copy_(0, rows, res_new[:, :k].reshape(-1, d))
                        else:
                            residuals.index_copy_(0, sel_c[:k], res_new[:k])
    return acc, vote, torch.stack(losses, -1), dsum, wsum, w_locals, residuals


def _chunk_weights(C: int, k: int, room, lead: tuple, dev) -> torch.Tensor:
    """The 0/1 f32 weights of a chunk's C rows: the first ``min(k, room)``
    count, where ``room`` is an int or, for a masked group, an (E,)
    tensor; a group's weights have its leading E."""
    if torch.is_tensor(room):
        return (torch.arange(C, device=dev) < torch.clamp(room, max=k).unsqueeze(-1)).float()
    w_c = (torch.arange(C, device=dev) < min(k, room)).float()
    return w_c.expand(lead + (C,)) if lead else w_c


def _per_run(fn, lead: tuple, *args):
    """``fn`` of one run's arguments, or stacked over a group's runs, each
    run's taken on its own rows (a float reduction over one axis of a
    group's tensor may round otherwise than over one run's)."""
    return torch.stack([fn(*run) for run in zip(*args)]) if lead else fn(*args)


def _attack_stream(attack_id, k_att, deltas, n_byz, row0):
    """:func:`~repro_torch.core.apply_attack_stream` on one run's (C, d)
    chunk, or on each run's own rows of a group's (E, C, d) with the run's
    own id and key (written into ``deltas``)."""
    if deltas.dim() == 2:
        return apply_attack_stream(attack_id, k_att, deltas, n_byz, row0)
    for i, rows in enumerate(deltas):
        attacked = apply_attack_stream(int(attack_id[i]), k_att[i], rows, n_byz, row0)
        if attacked is not rows:
            rows.copy_(attacked)
    return deltas


def _accumulate(server, kind, acc, wire, w_c, g0, lead):
    """Fold a chunk's wire into the carry (each run's into its own)."""
    if kind == "buffer":
        acc[..., g0:g0 + wire.updates.shape[-2], :] = wire.updates
        return acc
    if not lead:
        if kind == "counts":
            return server.accumulate_counts(acc, wire.packed, w_c)
        return server.accumulate_sum(acc, wire.updates, w_c)
    if kind == "counts":
        return torch.stack([server.accumulate_counts(acc[i], wire.packed[i], None if w_c is None else w_c[i])
                            for i in range(lead[0])])
    parts = [server.accumulate_sum((acc[0][i], acc[1][i]), wire.updates[i], w_c[i]) for i in range(lead[0])]
    return tuple(torch.stack(p) for p in zip(*parts))


def _add_in_order(parts: torch.Tensor) -> torch.Tensor:
    """Zero plus the entries of ``parts``, added one at a time in order (as
    the chunk loop's running sums are)."""
    total = parts.new_zeros(())
    for p in parts:
        total = total + p
    return total


def stream_fl_round(
    ctx: RoundContext, params: CellParams, key: torch.Tensor, state: RoundState, batches: dict
) -> tuple[RoundState, dict]:
    """One synchronous round over chunks of ``cfg.client_chunk`` clients:
    the protocol, key schedule and metrics of :func:`fl_round`, with
    ``batches = {"key": kb}`` (each chunk draws its own). The estimate is
    the server's finalize of the accumulated carry: the vote counts
    (weighted, with ``M^w`` the weight sum, when the chunk does not divide
    the cohort), FedAvg's weighted mean or Fed-GM's weighted median of the
    buffered rows. Metric means are sums times the f32 reciprocal of the
    weight sum. A masked context weighs cohort positions at or past the
    run's ``m_active`` 0, as the dense round's mask does. A sharded context
    (``ctx.group``) scans this rank's block of the cohort and sums the
    carries over the ranks (module docstring).

    A group of E runs, as :func:`fl_round`'s (a fused group's client data
    in ``batches["data"]``): each run draws its own cohort and chunks'
    batches, each kernel is launched once a chunk for the group, and each
    run's estimate and metric means are its single round's. Sharded, the
    group's carries cross the ranks in one collective each."""
    cfg, d, dev = ctx.cfg, ctx.d, ctx.device
    n, C = cfg.n_active, cfg.client_chunk
    lead = tuple(key.shape[:-1])
    server = ctx.pipeline.server
    if cfg.participation < 1.0:
        with record_function("round.sample"):
            sel = torch.stack([prng.choice(prng.fold_in(k, 99), cfg.n_clients, (n,)) for k in key.view(-1, 2)])
            sel = sel.view(lead + (n,))
    else:
        sel = torch.arange(cfg.n_clients, dtype=torch.int64, device=dev).expand(lead + (cfg.n_clients,))
    k_att, k_q = prng.split(prng.fold_in(key, 1), 2).unbind(-2)
    if not ctx.masked:
        limit = n
    elif lead:
        limit = torch.clamp(params.m_active, max=n)
    else:
        limit = min(n, int(params.m_active))
    group = ctx.group if cfg.stream_shard else None
    n_loc = n // distributed.group_size(group)
    row0 = distributed.group_rank(group) * n_loc
    weighted = ctx.masked or n_loc % C != 0
    acc, vote, losses, dsum, wsum, w_locals, residuals = _stream_chunks(
        ctx, params, batches["key"], k_att, k_q, state, sel[..., row0:row0 + n_loc], int(n * cfg.byz_frac),
        weighted, limit, row0=row0, data=batches.get("data"),
    )
    if group is not None:
        with record_function("round.collectives"):
            # each carry of the whole group in one collective: the vote
            # counts (or FedAvg's sum and weight), the b-vote, weight and
            # delta sums, and the chunks' loss sums in chunk order
            acc = (tuple(distributed.all_reduce_sum(a, group) for a in acc) if isinstance(acc, tuple)
                   else distributed.all_reduce_sum(acc, group))
            sums = distributed.all_reduce_sum(torch.cat([vote.unsqueeze(-1), wsum.unsqueeze(-1), dsum], -1), group)
            vote, wsum, dsum = sums[..., 0], sums[..., 1], sums[..., 2:]
            losses = distributed.all_gather_rows(losses, group).movedim(0, -2).flatten(-2)
    loss = _per_run(_add_in_order, lead, losses)
    with record_function("round.estimate"):
        if server.stream_kind == "counts":
            b_vec = ctx.pipeline.compressor.b_vector(d, state.b.b)
            if weighted:
                theta = _per_run(server.finalize_weighted, lead, acc, wsum, b_vec)
            else:
                theta = _per_run(lambda a, b: server.finalize(a, n, b), lead, acc, b_vec)
        elif server.stream_kind == "sum":
            theta = _per_run(lambda s_, w_: server.finalize_sum((s_, w_)), lead, *acc)
        else:
            w_all = _chunk_weights(acc.shape[-2], acc.shape[-2], limit, lead, dev)
            theta = _per_run(lambda a, w: server.from_dense(a, w if weighted else None), lead, acc, w_all)
    with record_function("round.finish"):
        b_new = update_b_from_vote(state.b, vote, cfg.bctrl)
        new_state = RoundState(w_global=state.w_global + theta, w_locals=w_locals, b=b_new, residuals=residuals)
        recip = torch.reciprocal(wsum.clamp(min=1.0))
        metrics = {
            "loss": loss * recip,
            "b": b_new.b,
            "theta_mse": _per_run(lambda t, ds, r: mean_rows((t - ds * r) ** 2), lead, theta, dsum, recip),
            "theta": theta,
        }
    return new_state, metrics


def _arrivals(key: torch.Tensor, latency, m: int) -> torch.Tensor:
    """Which of the ``m`` clients deliver this round: client ``i`` with
    probability ``1 / (1 + latency)``, the uniform of ``fold_in(key, 7)``
    compared with it in f32 as the reference's weakly typed scalar is
    (one latency a run for a group's (E, 2) keys)."""
    u = prng.uniform(prng.fold_in(key, 7), (m,))
    p_arrive = np.float32(1.0 / (1.0 + np.asarray(latency, np.float64)))
    if p_arrive.ndim == 0:
        return u < float(p_arrive)
    return u < torch.as_tensor(p_arrive, device=key.device).unsqueeze(-1)


def _staleness(age: torch.Tensor, decay, valid: torch.Tensor) -> torch.Tensor:
    """The buffer's staleness weights with the decay as an f32 device
    tensor (one a run for a group, each run's weights taken on its own
    row, so a group's equal its runs' own)."""
    if not torch.is_tensor(decay):
        decay = torch.tensor(decay, dtype=torch.float32, device=age.device)
    if age.dim() == 1:
        return staleness_weights(age, decay, valid)
    return torch.stack([staleness_weights(a, dc, v) for a, dc, v in zip(age, decay, valid)])


def async_fl_round(
    ctx: RoundContext, params: CellParams, key: torch.Tensor, state: AsyncRoundState, batches: dict
) -> tuple[AsyncRoundState, dict]:
    """One buffered-asynchronous round: the client side of :func:`fl_round`,
    then the arrivals fold into the buffer and the server estimates from
    it with staleness weights. Extra metrics: ``buf_fill`` (share of valid
    slots) and ``mean_age`` (mean age of the valid slots).

    A group of E runs, as :func:`fl_round`'s, with the buffer planes'
    leading E: each run draws its own arrivals with its own latency, arms
    its own straggler gate and weighs its slots with its own decay (an (E,)
    f32 device tensor, as ``lr``); the client side launches each kernel
    once a step for the group."""
    cfg, dev = ctx.cfg, ctx.device
    m, n_buf = cfg.n_active, cfg.async_buffer
    lead = tuple(key.shape[:-1])
    sel, w_new, loss_before, loss_after, deltas_att, wire, res_new = _client_uploads(
        ctx, params, key, state, batches
    )
    with record_function("round.estimate"):
        rows = wire.updates if isinstance(wire, DenseWire) else wire.packed
        delivered = _arrivals(key, params.latency, m)
        n_byz = int(m * cfg.byz_frac)
        gate = np.asarray(params.straggler_gate)
        if gate.any() and n_byz:
            # a Byzantine delivers only while no Byzantine upload sits in its slot
            owner = state.buf_owner[..., torch.arange(n_byz, device=dev) % n_buf]
            byz_delivered = ~((owner >= 0) & (owner < n_byz))
            if lead:
                armed = torch.as_tensor(gate, device=dev).view(lead + (1,))
                byz_delivered = torch.where(armed, byz_delivered, delivered[..., :n_byz])
            delivered = torch.cat([byz_delivered, delivered[..., n_byz:]], -1)
        # fold the M rows into the B slots, later clients winning a shared slot
        buf, owner, hit = state.buf_rows.clone(), state.buf_owner.clone(), torch.zeros_like(state.buf_valid)
        for g0 in range(0, m, n_buf):
            got = delivered[..., g0:g0 + n_buf]
            k = got.shape[-1]
            buf[..., :k, :] = torch.where(got.unsqueeze(-1), rows[..., g0:g0 + k, :], buf[..., :k, :])
            owner[..., :k] = torch.where(got, torch.arange(g0, g0 + k, dtype=torch.int32, device=dev), owner[..., :k])
            hit[..., :k] |= got
        age = torch.where(hit, torch.zeros_like(state.buf_age), state.buf_age + 1)
        valid = state.buf_valid | hit
        weights = _staleness(age, params.staleness_decay, valid)
        buf_wire = DenseWire(updates=buf) if isinstance(wire, DenseWire) else dataclasses.replace(wire, packed=buf)
        theta = ctx.pipeline.estimate(buf_wire, weights=weights)
    with record_function("round.finish"):
        new_state, metrics = _finish_round(
            ctx, state, w_new, loss_before, loss_after, res_new, theta, deltas_att, sel,
            buf_rows=buf, buf_age=age, buf_valid=valid, buf_owner=owner,
        )
        n_valid = valid.float().sum(-1)
        metrics["buf_fill"] = n_valid * recip32(n_buf)
        metrics["mean_age"] = (age.float() * valid).sum(-1) / n_valid.clamp(min=1.0)
    return new_state, metrics


@torch.no_grad()
def accuracy(ctx: RoundContext, w_global: torch.Tensor) -> torch.Tensor:
    """Test accuracy of the flat global model, a 0-dim tensor on its device
    (read it without waiting for the device: no host copy); (E,) for a
    group's (E, d) models, each taken on its own."""
    if w_global.dim() == 2:
        return torch.stack([accuracy(ctx, w) for w in w_global])
    return ctx.acc_fn(ctx.unravel(w_global), ctx.test)


def evaluate(ctx: RoundContext, w_global: torch.Tensor) -> float:
    """Test accuracy of the flat global model."""
    return float(accuracy(ctx, w_global))


def run_rounds(
    ctx: RoundContext,
    params: CellParams,
    key: torch.Tensor,
    state: RoundState,
    rounds: int | None = None,
    *,
    data=None,
    with_acc: bool = True,
) -> tuple[RoundState, dict]:
    """Run ``rounds`` rounds (the config's by default) of the round the
    context calls for, on ``FLSimulation.run``'s key schedule (each round
    ``key, kb, kr = split(key, 3)``; batches from ``kb``, the round from
    ``kr``), so at a fixed seed this is the sequential driver's run.

    Keys (E, 2) with a state of leading E run a group of E runs at once
    (the group form of the round; ``data``, a fused group's client data,
    see :func:`round_batches`). Returns the final
    state and each metric's trajectory, a ``(rounds,)`` tensor (``(E,
    rounds)`` for a group) on the context's device (``acc`` included when
    ``with_acc``; the (d,) ``theta`` is not kept). Nothing waits for the
    device.
    """
    rounds = rounds or ctx.cfg.rounds
    step = round_fn(ctx)
    traj: dict[str, list] = {}
    for _ in range(rounds):
        key, kb, kr = prng.split(key, 3).unbind(-2)
        state, metrics = step(ctx, params, kr, state, round_batches(ctx, kb, data))
        metrics.pop("theta")
        if with_acc:
            metrics["acc"] = accuracy(ctx, state.w_global)
        for name, value in metrics.items():
            traj.setdefault(name, []).append(value)
    return state, {name: torch.stack(values, dim=-1) for name, values in traj.items()}
