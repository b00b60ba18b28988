"""What every cell shares: the record of a run's first rounds, the leaf
comparisons behind ``correct``, and the faults planted under the window's
call for the benchmark's own tests and readings.

The reference follows the program round by round: round 1 from the
seed's state, each later round from the state the program reached (each
cell's ``check``). A gap therefore reads what one round of the program
did differently, and no difference carries over into the next round.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
import unittest.mock as mock

import torch


@dataclasses.dataclass
class Record:
    """What each compared round produced (one dict a round)."""

    rounds: list = dataclasses.field(default_factory=list)


def rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def leaf_gaps(prog: dict, ref: dict, start: dict, device) -> tuple[float, float]:
    """``(change_norm_gap, param_gap)`` of one round over the leaves
    ``{name: tensor}``: by the worst leaf, the gap between the two sides'
    norms of the change from ``start``, and the norm of the difference of
    the two sides, each against the reference's norm of that leaf's change
    or of the median leaf's, whichever is larger."""
    norms = []
    for name, w0 in start.items():
        w0 = w0.to(device, torch.float64).reshape(-1)
        wp = prog[name].to(device, torch.float64).reshape(-1)
        wr = ref[name].to(device, torch.float64).reshape(-1)
        norms.append((float((wp - w0).norm()), float((wr - w0).norm()), float((wp - wr).norm())))
    med = statistics.median(c for _, c, _ in norms)
    change = max(abs(cp - cr) / max(cr, med, 1e-30) for cp, cr, _ in norms)
    diff = max(d / max(cr, med, 1e-30) for _, cr, d in norms)
    return change, diff


def finite(numbers: dict) -> dict:
    return {k: (v if v is not None and math.isfinite(v) else None) for k, v in numbers.items()}


def judge(numbers: dict, limits: dict) -> bool:
    """Correct when every limited number is finite and at most its limit."""
    return all(numbers.get(k) is not None and numbers[k] <= lim for k, lim in limits.items())


@contextlib.contextmanager
def half_clients():
    """The server's estimate over the first half of the uploaded rows, the
    mean taken over them alone."""
    from repro_torch.core.aggregation import AggregatorPipeline

    estimate = AggregatorPipeline.estimate

    def half(self, wire, weights=None):
        rows = wire.packed.shape[-2]
        return estimate(self, dataclasses.replace(wire, packed=wire.packed[..., : rows // 2, :].contiguous()), weights)

    with mock.patch.object(AggregatorPipeline, "estimate", half):
        yield


@contextlib.contextmanager
def flip_row():
    """Client 0's upload inverted where it is produced: every bit of its
    packed row flipped."""
    from repro_torch.core.aggregation import ClientCompressor

    compress = ClientCompressor.compress

    def flipped(self, key, deltas, b_scalar, residuals, *, row_offset=0):
        wire, res = compress(self, key, deltas, b_scalar, residuals, row_offset=row_offset)
        if row_offset == 0:
            packed = wire.packed.clone()
            packed[..., 0, :] = ~packed[..., 0, :]
            wire = dataclasses.replace(wire, packed=packed)
        return wire, res

    with mock.patch.object(ClientCompressor, "compress", flipped):
        yield
