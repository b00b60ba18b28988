"""A campaign group's inputs for the round's group form.

Counterpart of ``jax.vmap(cell_fn)`` in ``repro/sim/campaign.py``: where
the reference vmaps one run's round over the group's E runs (and each
Pallas kernel is launched once for the group through its batching rule),
every round of the port (:func:`repro_torch.fl.rounds.fl_round`,
:func:`~repro_torch.fl.rounds.stream_fl_round`,
:func:`~repro_torch.fl.rounds.async_fl_round` and
:func:`repro_torch.fl.hierarchy.tree_fl_round`, on every wire) and
:func:`~repro_torch.fl.rounds.run_rounds` take a leading E on the keys,
the state and the batches, and launch each kernel once a step (a streamed
round or a tree's edge: once a chunk's step) for the whole group. This
module builds what that call needs:

* **State** (:func:`init_group_state`): ``w_global`` (E, d),
  ``w_locals`` and ``residuals`` (E, M, d) ((E, 1, d) for stateless
  clients), ``b`` (E,), and an asynchronous run's buffer planes (E, B,
  ...) or a buffered tree's edge buffer (E, B, 8P), made directly in
  their stacked form.
* **Params** (:func:`device_params`): ``lr``, ``momentum``, ``lam`` and
  ``staleness_decay`` as (E,) f32 tensors on the device, where the prox
  kernel and the staleness weights read them (and a fused group's
  ``m_active``, from which each round makes the (E, M) active-client
  mask).
* **Data** (:class:`GroupData`): a fused group's client data, one row a
  cell; each run's batches come from its own cell's rows.

Every group the planner makes runs so; none runs one run at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import BState, init_b_state
from ..fl import rounds as R

__all__ = ["GroupData", "init_group_state", "device_params"]


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
    E: what :func:`~repro_torch.fl.rounds.init_run_state` gives each run
    (asynchronous, a buffered tree's or synchronous), made as one plane of
    each kind."""
    cfg, e = ctx.cfg, len(b_inits)
    n_rows = 1 if cfg.stateless_clients else cfg.n_clients
    bs = [init_b_state(dataclasses.replace(cfg.bctrl, init=b0), ctx.device) for b0 in b_inits]
    state = R.RoundState(
        w_global=ctx.w0.repeat(e, 1),
        w_locals=ctx.w0.repeat(e, n_rows, 1),
        b=BState(b=torch.stack([s.b for s in bs]), prev_vote=torch.stack([s.prev_vote for s in bs])),
        residuals=torch.zeros((e, n_rows, ctx.d), dtype=torch.float32, device=ctx.device),
    )
    dev = ctx.device
    if cfg.tree_edges and cfg.edge_buffer:
        from ..fl.hierarchy import TreeRoundState

        n_buf, p_bytes = cfg.edge_buffer, ctx.pipeline.compressor.wire_bytes(ctx.d)
        return TreeRoundState(
            **vars(state),
            edge_counts=torch.zeros((e, n_buf, 8 * p_bytes), dtype=torch.float32, device=dev),
            edge_mass=torch.zeros((e, n_buf), dtype=torch.float32, device=dev),
            edge_age=torch.zeros((e, n_buf), dtype=torch.int32, device=dev),
            edge_valid=torch.zeros((e, n_buf), dtype=torch.bool, device=dev),
        )
    if not cfg.async_buffer:
        return state
    n_buf = cfg.async_buffer
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
