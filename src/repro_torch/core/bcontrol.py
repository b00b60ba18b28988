"""Dynamic quantization-range controller for ``b`` (paper §VI-B).

Counterpart of ``repro/core/bcontrol.py``. Each client uploads one extra
bit a round: +1 if its local loss decreased during local training, -1
otherwise. The server sums the votes; on a positive sum ``b`` is
multiplied by ``up`` (1.01), otherwise (a tie included) by ``down``
(0.98). ``fixed`` mode freezes ``b``. The omniscient ``oracle`` mode
ranges each coordinate by the cohort's largest update (:func:`oracle_b`);
the scalar controller still votes beside it, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from .privacy import DPConfig, dp_b_floor

__all__ = [
    "BControlConfig",
    "BState",
    "init_b_state",
    "loss_bit",
    "oracle_b",
    "update_b",
    "update_b_from_vote",
]


@dataclasses.dataclass(frozen=True)
class BControlConfig:
    mode: str = "dynamic"  # dynamic | fixed | oracle
    init: float = 0.01
    up: float = 1.01
    down: float = 0.98


@dataclasses.dataclass(frozen=True)
class BState:
    """Scalar controller state as 0-dim f32 tensors on the round's device."""

    b: torch.Tensor
    prev_vote: torch.Tensor  # last vote sum, for logging


def init_b_state(cfg: BControlConfig, device=None) -> BState:
    return BState(
        b=torch.tensor(cfg.init, dtype=torch.float32, device=device),
        prev_vote=torch.tensor(0.0, dtype=torch.float32, device=device),
    )


def loss_bit(loss_before: torch.Tensor, loss_after: torch.Tensor) -> torch.Tensor:
    """The one-bit training signal a client uploads: +1 = loss decreased
    (strictly), else -1."""
    return torch.where(loss_after < loss_before, 1, -1).to(torch.int8)


def update_b(state: BState, bits: torch.Tensor, cfg: BControlConfig, weights: torch.Tensor | None = None) -> BState:
    """Sum the loss bits and rescale ``b``. ``weights`` (one per bit)
    restricts the vote to a sub-cohort: a fused campaign group passes its
    0/1 active-client mask, so padded clients cast no vote (a float sum of
    masked +-1 bits is exact below 2**24 clients). Bits ``(E, M)`` with
    ``b`` ``(E,)`` vote each run on its own."""
    votes = bits.float()
    if weights is not None:
        votes = votes * weights
    return update_b_from_vote(state, votes.sum(-1), cfg)


def update_b_from_vote(state: BState, vote: torch.Tensor, cfg: BControlConfig) -> BState:
    """Rescale ``b`` from an already-summed vote: ``up`` only on vote > 0.
    The factor is f32, as in the reference."""
    if cfg.mode == "fixed":
        return BState(b=state.b * 1.0, prev_vote=vote)
    up = torch.tensor(cfg.up, dtype=torch.float32, device=state.b.device)
    down = torch.tensor(cfg.down, dtype=torch.float32, device=state.b.device)
    return BState(b=state.b * torch.where(vote > 0, up, down), prev_vote=vote)


def oracle_b(updates: torch.Tensor, dp: DPConfig) -> torch.Tensor:
    """Omniscient per-coordinate range: ``max_m |delta_i^m|`` plus the DP
    margin (:func:`~repro_torch.core.privacy.dp_b_floor`); (E, M, d)
    updates of a group give each run its own (E, d) range."""
    return dp_b_floor(updates.abs().amax(-2), dp)
