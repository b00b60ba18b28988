"""Federated rounds and the simulation that runs them."""

from .rounds import CellParams, RoundContext, RoundState, evaluate, fl_round, init_state, make_context, round_batches
from .runtime import FLConfig, FLSimulation

__all__ = [
    "FLConfig",
    "FLSimulation",
    "RoundState",
    "CellParams",
    "RoundContext",
    "make_context",
    "init_state",
    "round_batches",
    "fl_round",
    "evaluate",
]
