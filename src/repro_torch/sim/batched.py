"""A campaign group's inputs for the round's group form.

Counterpart of ``jax.vmap(cell_fn)`` in ``repro/sim/campaign.py``: where
the reference vmaps one run's round over the group's E runs (and each
Pallas kernel is launched once for the group through its batching rule),
the port's rounds (:func:`repro_torch.fl.rounds.fl_round`,
:func:`~repro_torch.fl.rounds.stream_fl_round` and
:func:`~repro_torch.fl.rounds.async_fl_round`) and
:func:`~repro_torch.fl.rounds.run_rounds` take a leading E on the keys,
the state and the batches, and launch each kernel once a step (a streamed
round: once a chunk's step) for the whole group. This module builds what
that call needs:

* **State** (:func:`init_group_state`): ``w_global`` (E, d),
  ``w_locals`` and ``residuals`` (E, M, d) ((E, 1, d) for stateless
  clients), ``b`` (E,), and an asynchronous run's buffer planes (E, B,
  ...), made directly in their stacked form.
* **Params** (:func:`device_params`): ``lr``, ``momentum``, ``lam`` and
  ``staleness_decay`` as (E,) f32 tensors on the device, where the prox
  kernel and the staleness weights read them (and a fused group's
  ``m_active``, from which each round makes the (E, M) active-client
  mask).
* **Data** (:class:`GroupData`): a fused group's client data, one row a
  cell; each run's batches come from its own cell's rows.

Tree groups, groups whose streamed cohort is sharded over the ranks
(``stream_shard``), and groups on the k-bit, mixed-width or top-k wires
are not :func:`batchable`: they run one run at a time through
``run_rounds`` (ROADMAP A11b lists batching the trees and the wires as
later work).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import BState, init_b_state
from ..fl import rounds as R

__all__ = ["batchable", "GroupData", "init_group_state", "device_params"]


def batchable(cfg) -> bool:
    """Does a group of this config run as one group (the synchronous,
    streamed or asynchronous round's group form, on the one-bit or dense
    wires)? Tree groups, sharded streamed cohorts and the k-bit,
    mixed-width and top-k wires run one run at a time."""
    return (cfg.tree_edges == 0 and not cfg.stream_shard and cfg.wire_bits == 1 and cfg.client_bits is None
            and cfg.topk_frac >= 1.0)


@dataclasses.dataclass(frozen=True)
class GroupData:
    """A fused group's client data on the device: every cell's clients
    padded to the group's cohort, ``(cells, m_pad, per_client, ...)``, and
    the cell of each run, ``data_idx`` (E,)."""

    client_x: torch.Tensor
    client_y: torch.Tensor
    data_idx: torch.Tensor


def init_group_state(ctx: R.RoundContext, b_inits) -> R.RoundState:
    """The fresh state of E runs, one a ``b_inits`` entry, with a leading
    E: what :func:`~repro_torch.fl.rounds.init_run_state` gives each run,
    made as one plane of each kind."""
    cfg, e = ctx.cfg, len(b_inits)
    n_rows = 1 if cfg.stateless_clients else cfg.n_clients
    bs = [init_b_state(dataclasses.replace(cfg.bctrl, init=b0), ctx.device) for b0 in b_inits]
    state = R.RoundState(
        w_global=ctx.w0.repeat(e, 1),
        w_locals=ctx.w0.repeat(e, n_rows, 1),
        b=BState(b=torch.stack([s.b for s in bs]), prev_vote=torch.stack([s.prev_vote for s in bs])),
        residuals=torch.zeros((e, n_rows, ctx.d), dtype=torch.float32, device=ctx.device),
    )
    if not cfg.async_buffer:
        return state
    n_buf, dev = cfg.async_buffer, ctx.device
    n_bytes = ctx.pipeline.compressor.wire_bytes(ctx.d)
    if n_bytes is None:
        rows = torch.zeros((e, n_buf, ctx.d), dtype=torch.float32, device=dev)
    else:
        rows = torch.zeros((e, n_buf, n_bytes), dtype=torch.uint8, device=dev)
    return R.AsyncRoundState(
        **vars(state),
        buf_rows=rows,
        buf_age=torch.zeros((e, n_buf), dtype=torch.int32, device=dev),
        buf_valid=torch.zeros((e, n_buf), dtype=torch.bool, device=dev),
        buf_owner=torch.full((e, n_buf), -1, dtype=torch.int32, device=dev),
    )


def device_params(params: R.CellParams, device) -> R.CellParams:
    """A group's stacked ``params`` with ``lr``, ``momentum``, ``lam`` and
    ``staleness_decay`` as (E,) f32 tensors on ``device`` (the prox kernel
    and the staleness weights read them there), and ``m_active``, when
    set, as an (E,) tensor there too. The latency stays on the host: each
    run's arrival probability is an f32 constant made from it."""
    def on_device(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    m_active = None if params.m_active is None else on_device(params.m_active, np.int64)
    return dataclasses.replace(params, lr=on_device(params.lr), momentum=on_device(params.momentum),
                               lam=on_device(params.lam), staleness_decay=on_device(params.staleness_decay),
                               m_active=m_active)
