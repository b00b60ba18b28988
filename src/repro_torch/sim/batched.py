"""A campaign group's inputs for the synchronous round's group form.

Counterpart of ``jax.vmap(cell_fn)`` in ``repro/sim/campaign.py``: where
the reference vmaps one run's round over the group's E runs (and each
Pallas kernel is launched once for the group through its batching rule),
the port's :func:`repro_torch.fl.rounds.fl_round` and
:func:`~repro_torch.fl.rounds.run_rounds` take a leading E on the keys,
the state and the batches, and launch each kernel once a step for the
whole group. This module builds what that call needs:

* **State** (:func:`init_group_state`): ``w_global`` (E, d),
  ``w_locals`` and ``residuals`` (E, M, d), ``b`` (E,), made directly in
  their stacked form.
* **Params** (:func:`device_params`): ``lr``, ``momentum`` and ``lam``
  as (E,) f32 tensors on the device, which the prox kernel reads there
  (and a fused group's ``m_active``, from which each round makes the
  (E, M) active-client mask).
* **Data** (:class:`GroupData`): a fused group's client data, one row a
  cell; each run's batches come from its own cell's rows.

Asynchronous, streamed and tree groups, and groups on the k-bit,
mixed-width or top-k wires, are not :func:`batchable`: they run one run at
a time through ``run_rounds`` (ROADMAP A11b lists batching them as later
work).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import BState, init_b_state
from ..fl import rounds as R

__all__ = ["batchable", "GroupData", "init_group_state", "device_params"]


def batchable(cfg) -> bool:
    """Does a group of this config run as one group (the synchronous dense
    round's group form, on the one-bit or dense wires)? Asynchronous,
    streamed and tree groups and the k-bit, mixed-width and top-k wires run
    one run at a time."""
    return (cfg.async_buffer == 0 and cfg.client_chunk == 0 and cfg.wire_bits == 1 and cfg.client_bits is None
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
    """The fresh state of E synchronous runs, one a ``b_inits`` entry, with
    a leading E: what :func:`~repro_torch.fl.rounds.init_state` gives each
    run, made as one (E, M, d) plane of each kind."""
    e, m = len(b_inits), ctx.cfg.n_clients
    bs = [init_b_state(dataclasses.replace(ctx.cfg.bctrl, init=b0), ctx.device) for b0 in b_inits]
    return R.RoundState(
        w_global=ctx.w0.repeat(e, 1),
        w_locals=ctx.w0.repeat(e, m, 1),
        b=BState(b=torch.stack([s.b for s in bs]), prev_vote=torch.stack([s.prev_vote for s in bs])),
        residuals=torch.zeros((e, m, ctx.d), dtype=torch.float32, device=ctx.device),
    )


def device_params(params: R.CellParams, device) -> R.CellParams:
    """A group's stacked ``params`` with ``lr``, ``momentum`` and ``lam``
    as (E,) f32 tensors on ``device`` (the prox kernel reads them there),
    and ``m_active``, when set, as an (E,) tensor there too."""
    def on_device(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    m_active = None if params.m_active is None else on_device(params.m_active, np.int64)
    return dataclasses.replace(params, lr=on_device(params.lr), momentum=on_device(params.momentum),
                               lam=on_device(params.lam), m_active=m_active)
