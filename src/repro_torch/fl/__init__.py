"""Federated rounds and the simulation that runs them."""

from .rounds import (
    AsyncRoundState,
    CellParams,
    RoundContext,
    RoundState,
    async_fl_round,
    cell_params,
    client_mask,
    evaluate,
    fl_round,
    init_async_state,
    init_run_state,
    init_state,
    make_context,
    round_batches,
    round_fn,
    run_rounds,
    stream_fl_round,
)
from .runtime import FLConfig, FLSimulation

__all__ = [
    "FLConfig",
    "FLSimulation",
    "RoundState",
    "AsyncRoundState",
    "CellParams",
    "RoundContext",
    "make_context",
    "init_state",
    "init_async_state",
    "init_run_state",
    "round_batches",
    "fl_round",
    "stream_fl_round",
    "async_fl_round",
    "round_fn",
    "evaluate",
    "cell_params",
    "client_mask",
    "run_rounds",
]
