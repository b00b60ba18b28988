"""Campaign result containers: per-cell trajectories, CIs, JSON artifacts.

Counterpart of ``repro/sim/metrics.py`` (plain numpy, the same keys). A
campaign run produces, per (cell, seed), the full per-round metric
trajectories recorded by :func:`repro_torch.fl.rounds.run_rounds` (one run
at a time, or a group of runs at once) — test accuracy, mean
local loss, the dynamic-b value, and ``theta_mse`` (the aggregation error
against the true mean of the uploaded updates, the quantity Theorem 1
bounds at O(1/M)) — plus the host-side ``eps_spent`` trajectory: the
cumulative DP budget after each round under the cell's ``dp_accountant``
(:class:`repro_torch.core.PrivacyLedger`; seed-independent, tiled across
the seed axis, so it rides the same CellResult/JSON paths as every
measured metric). :class:`CampaignResult` groups them by cell, summarizes
across seeds as mean ± normal-approximation CI, and serializes to the
reference's JSON artifact structure; :meth:`CampaignResult.emit_rows`
yields ``(name, us_per_round, derived)`` rows of the reference's form.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator

import numpy as np

__all__ = ["mean_ci", "CellResult", "CampaignResult"]

_Z95 = 1.96


def mean_ci(a: np.ndarray, axis: int = 0, z: float = _Z95) -> tuple[np.ndarray, np.ndarray]:
    """Mean and z*SEM half-width along ``axis`` (0-width for one sample)."""
    a = np.asarray(a, np.float64)
    n = a.shape[axis]
    mean = a.mean(axis=axis)
    if n < 2:
        return mean, np.zeros_like(mean)
    half = z * a.std(axis=axis, ddof=1) / np.sqrt(n)
    return mean, half


@dataclasses.dataclass
class CellResult:
    """One scenario cell: metric trajectories over seeds.

    ``metrics[name]`` has shape ``(n_seeds, rounds)``.
    """

    name: str
    overrides: dict
    metrics: dict[str, np.ndarray]

    @property
    def rounds(self) -> int:
        return next(iter(self.metrics.values())).shape[1]

    def final(self, metric: str = "acc") -> tuple[float, float]:
        """(mean, ci_half_width) of the last-round value across seeds."""
        mean, half = mean_ci(self.metrics[metric][:, -1])
        return float(mean), float(half)

    def trajectory(self, metric: str = "acc") -> tuple[np.ndarray, np.ndarray]:
        """Per-round (mean, ci_half_width) across seeds."""
        return mean_ci(self.metrics[metric], axis=0)

    def eps_spent(self) -> float:
        """Cumulative DP budget at the last round (0.0 for non-DP cells or
        results predating the privacy ledger)."""
        if "eps_spent" not in self.metrics:
            return 0.0
        return self.final("eps_spent")[0]

    def mean_over_rounds(self, metric: str, tail: int | None = None) -> float:
        """Seed-and-round mean of a metric (optionally last ``tail`` rounds)."""
        a = self.metrics[metric]
        if tail:
            a = a[:, -tail:]
        return float(np.mean(a))


@dataclasses.dataclass
class CampaignResult:
    """All cells of a campaign plus execution accounting.

    ``groups`` records how the planner batched the grid: one entry per
    compiled program with its member cells, wall/compile seconds, compile-
    cache hit flag, fused/m_pad, ``n_devices``, ``cells_per_sec``, and the
    padded-vs-real (cell, seed) element counts.
    """

    cells: list[CellResult]
    seeds: tuple[int, ...]
    groups: list[dict]
    wall_s: float

    @property
    def cells_per_sec(self) -> float:
        """Real (cell, seed) elements per campaign wall-second."""
        n = len(self.cells) * len(self.seeds)
        return n / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def n_devices(self) -> int:
        """Devices the widest group ran on (1 when unsharded)."""
        return max((g.get("n_devices", 1) for g in self.groups), default=1)

    def cell(self, name: str) -> CellResult:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(f"no cell named {name!r}; have {[c.name for c in self.cells]}")

    def final(self, metric: str = "acc") -> dict[str, tuple[float, float]]:
        return {c.name: c.final(metric) for c in self.cells}

    def emit_rows(self, prefix: str = "campaign") -> Iterator[tuple[str, float, str]]:
        """``(name, us_per_round, derived)`` rows: per-cell amortized cost.

        ``us_per_round`` divides each group's wall-clock evenly over its
        (cell, seed, round) work items — the apples-to-apples number
        against the sequential driver's per-round cost.
        """
        per_cell_us: dict[str, float] = {}
        for g in self.groups:
            work = sum(self.cell(n).rounds for n in g["cells"]) * len(self.seeds)
            us = g["wall_s"] / max(work, 1) * 1e6
            for n in g["cells"]:
                per_cell_us[n] = us
        for c in self.cells:
            # campaigns run with with_acc=False have no "acc" trajectory
            metric = "acc" if "acc" in c.metrics else next(iter(c.metrics))
            mean, half = c.final(metric)
            yield (
                f"{prefix}_{c.name}",
                per_cell_us[c.name],
                f"{metric}={mean:.4f}±{half:.4f}",
            )

    def to_json(self) -> dict:
        return {
            "seeds": list(self.seeds),
            "wall_s": self.wall_s,
            "cells_per_sec": self.cells_per_sec,
            "n_devices": self.n_devices,
            # Full execution accounting per compiled program: wall/compile
            # seconds, cache hit, fused/m_pad, n_devices, cells_per_sec,
            # and padded-vs-real element counts.
            "groups": [
                {k: _jsonable(v) for k, v in g.items()} for g in self.groups
            ],
            "cells": {
                c.name: {
                    "overrides": {k: _jsonable(v) for k, v in c.overrides.items()},
                    "final": {m: c.final(m) for m in c.metrics},
                    "trajectory_mean": {
                        m: np.asarray(c.trajectory(m)[0]).tolist() for m in c.metrics
                    },
                    # z*SEM half-width per round, so plots rendered from
                    # the JSON artifact on disk keep their CI bands (zeros
                    # for a single seed).
                    "trajectory_ci": {
                        m: np.asarray(c.trajectory(m)[1]).tolist() for m in c.metrics
                    },
                }
                for c in self.cells
            },
        }

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path


def _jsonable(v: Any):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v
