"""One synchronous round (paper Algorithm 1) as state -> state.

Counterpart of the synchronous half of ``repro/fl/rounds.py``
(:func:`fl_round` and what it calls), with the reference's key schedule,
so at a fixed seed the port draws the reference's client batches and
quantizer bits:

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

Each step runs under a ``torch.profiler.record_function`` range
(``round.batches``, ``round.sample`` under partial participation,
``round.local_train``, ``round.compress``,
``round.estimate``, ``round.finish``), so a profiler trace splits a
round's device time by step; with no profiler active a range costs a few
microseconds of host time.

Not ported yet: the streaming, asynchronous and tree rounds and the
masked campaign contexts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from .. import prng
from ..core import BState, apply_attack, attack_id, init_b_state, is_wire_attack, loss_bit, update_b
from ..core.aggregation import mean_rows
from ..interop import ravel_params
from ..optim import local_prox_train

__all__ = [
    "RoundState",
    "CellParams",
    "RoundContext",
    "make_context",
    "init_state",
    "cell_params",
    "round_batches",
    "fl_round",
    "evaluate",
]


@dataclasses.dataclass(frozen=True)
class RoundState:
    """Evolving state of one FL run (tensors on the run's device)."""

    w_global: torch.Tensor  # (d,)
    w_locals: torch.Tensor  # (n_clients, d) personal models
    b: BState  # dynamic-b controller state
    residuals: torch.Tensor  # (n_clients, d) error-feedback residuals


@dataclasses.dataclass(frozen=True)
class CellParams:
    """Per-run scenario knobs (scalars)."""

    lr: float
    momentum: float
    lam: float
    attack_id: int  # index into repro_torch.core.ATTACK_IDS (delta stage)


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
    flip_n: int  # rows bit-flipped on the wire by the bit_flip adversary
    device: torch.device
    engine: str | None = None  # kernel engine passed to ops (None: by device)

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
) -> RoundContext:
    """Resolve a config and a task into a RoundContext on ``device``.

    ``init_params`` is a (nested) dict of arrays in the reference's layout;
    ``engine`` forces the kernel engine of every ``ops`` call (``"ref"``
    runs the plain versions on the card).
    """
    device = torch.device(device)
    w0, unravel = ravel_params(init_params, device)
    n_byz = int(cfg.n_active * cfg.byz_frac)
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
        flip_n=n_byz if is_wire_attack(cfg.attack) else 0,
        device=device,
        engine=engine,
    )


def init_state(ctx: RoundContext) -> RoundState:
    cfg = ctx.cfg
    return RoundState(
        w_global=ctx.w0,
        w_locals=ctx.w0.unsqueeze(0).repeat(cfg.n_clients, 1),
        b=init_b_state(cfg.bctrl, ctx.device),
        residuals=torch.zeros((cfg.n_clients, ctx.d), dtype=torch.float32, device=ctx.device),
    )


def cell_params(cfg) -> CellParams:
    return CellParams(lr=cfg.lr, momentum=cfg.momentum, lam=cfg.lam, attack_id=attack_id(cfg.attack))


def _batch_steps(ctx: RoundContext) -> int:
    cfg = ctx.cfg
    return max(cfg.local_epochs * ctx.client_x.shape[1] // cfg.batch_size, 1)


def _client_batch_idx(ctx: RoundContext, key: torch.Tensor, client_ids: torch.Tensor) -> torch.Tensor:
    """Batch indices (n, steps, batch) of the given clients, each keyed by
    ``fold_in(key, client_id)`` as in the reference."""
    keys = prng.fold_in(key, client_ids)
    return prng.randint(keys, (_batch_steps(ctx), ctx.cfg.batch_size), 0, ctx.client_x.shape[1])


def round_batches(ctx: RoundContext, key: torch.Tensor) -> dict:
    """One round's local-training batches of every client:
    ``{"x": (n, steps, batch, ...), "y": (n, steps, batch)}``."""
    n = ctx.cfg.n_clients
    with record_function("round.batches"):
        ids = torch.arange(n, dtype=torch.int64, device=ctx.device)
        idx = _client_batch_idx(ctx, key, ids)
        rows = ids.view(n, 1, 1)
        return {"x": ctx.client_x[rows, idx], "y": ctx.client_y[rows, idx]}


def _client_uploads(ctx, params, key, state, batches):
    """The client side of a round: participation sampling, local
    prox-training, delta attack, and compression onto the wire. ``sel`` is
    None at full participation."""
    cfg = ctx.cfg
    w_sel, res_sel, sel = state.w_locals, state.residuals, None
    if cfg.participation < 1.0:
        with record_function("round.sample"):
            sel = prng.choice(prng.fold_in(key, 99), cfg.n_clients, (cfg.n_active,))
            w_sel, res_sel = w_sel.index_select(0, sel), res_sel.index_select(0, sel)
            batches = {k: v.index_select(0, sel) for k, v in batches.items()}
    with record_function("round.local_train"):
        w_new, loss_before, loss_after = local_prox_train(
            ctx.loss_fn, state.w_global, w_sel, ctx.unravel, batches,
            lr=params.lr, mu=params.momentum, lam=params.lam,
            use_kernel=cfg.use_kernels, engine=ctx.engine,
        )
    with record_function("round.compress"):
        deltas = w_new - state.w_global
        k_att, k_q = prng.split(prng.fold_in(key, 1), 2)
        n_byz = int(cfg.n_active * cfg.byz_frac)
        deltas_att = apply_attack(params.attack_id, k_att, deltas, n_byz)
        wire, res_new = ctx.pipeline.compress_wire(
            k_q, deltas_att, state.b.b, res_sel, flip_n=ctx.flip_n
        )
    return sel, w_new, loss_before, loss_after, deltas_att, wire, res_new


def _finish_round(ctx, state, w_new, loss_before, loss_after, res_new, theta, deltas_att, sel=None):
    """Server epilogue: global step, b-control, write-back of the active
    clients' state at ``sel`` (all clients when None), metrics."""
    cfg = ctx.cfg
    b_new = update_b(state.b, loss_bit(loss_before, loss_after), cfg.bctrl)
    if sel is not None:
        w_new = state.w_locals.index_copy(0, sel, w_new)
        res_new = state.residuals.index_copy(0, sel, res_new)
    new_state = RoundState(
        w_global=state.w_global + theta, w_locals=w_new, b=b_new, residuals=res_new
    )
    metrics = {
        "loss": mean_rows(loss_after),
        "b": b_new.b,
        "theta_mse": mean_rows((theta - mean_rows(deltas_att)) ** 2),
        "theta": theta,
    }
    return new_state, metrics


def fl_round(
    ctx: RoundContext, params: CellParams, key: torch.Tensor, state: RoundState, batches: dict
) -> tuple[RoundState, dict]:
    """One FL round: local prox-training, attack, aggregate, b-control.

    Returns the next state and the round's metrics as tensors: ``loss``
    (mean post-training local loss), ``b`` (after the vote),
    ``theta_mse`` (squared error of theta_hat against the mean uploaded
    update, the aggregation error Theorem 1 bounds) and ``theta``, the
    (d,) estimate itself.
    """
    sel, w_new, loss_before, loss_after, deltas_att, wire, res_new = _client_uploads(
        ctx, params, key, state, batches
    )
    with record_function("round.estimate"):
        theta = ctx.pipeline.estimate(wire)
    with record_function("round.finish"):
        return _finish_round(ctx, state, w_new, loss_before, loss_after, res_new, theta, deltas_att, sel)


@torch.no_grad()
def evaluate(ctx: RoundContext, w_global: torch.Tensor) -> float:
    """Test accuracy of the flat global model."""
    return float(ctx.acc_fn(ctx.unravel(w_global), ctx.test))
