"""Differential-privacy configuration and composition (paper Theorem 3).

Counterpart of ``repro/core/privacy.py`` for the one-bit wire. The
compressor of Eq. 5 is a local randomizer; it is ``(eps, 0)``-DP per round
when the public range satisfies

    b_i >= max_m |delta_i^m| + (1 + 1/eps) * Delta_1

The randomized-response mixing of the k-bit wire (``rr_gamma``) and the
empirical ``privacy_loss`` come with the k-bit slice of the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "DPConfig",
    "DELTA_SLACK",
    "dp_b_floor",
    "basic_composition",
    "strong_composition",
    "advanced_composition",
    "rounds_for_budget",
]

# Failure probability spent by the advanced (DRV) accountant.
DELTA_SLACK = 1e-5


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Per-round local-DP requirement; ``epsilon <= 0`` disables privacy."""

    epsilon: float = 0.1
    l1_sensitivity: float = 2e-4  # paper: 0.02 * eta with eta = 0.01

    @property
    def enabled(self) -> bool:
        return self.epsilon > 0

    @property
    def b_margin(self) -> float:
        """Theorem 3's margin ``(1 + 1/eps) * Delta_1`` added to ``b``."""
        return (1.0 + 1.0 / self.epsilon) * self.l1_sensitivity


def dp_b_floor(delta_abs_max, cfg: DPConfig):
    """Smallest ``b`` satisfying Theorem 3 given ``max_m |delta_i^m|``."""
    if not cfg.enabled:
        return delta_abs_max
    return delta_abs_max + cfg.b_margin


def basic_composition(eps_per_round: float, rounds: int) -> float:
    """Basic sequential composition across ``rounds``."""
    return eps_per_round * rounds


def strong_composition(eps_sq_sum, linear_sum, delta_slack: float):
    """Dwork-Rothblum-Vadhan kernel shared by every advanced-composition
    call site: ``sqrt(2 ln(1/delta') sum eps_t^2) + sum eps_t (e^eps_t - 1)``."""
    return np.sqrt(2.0 * math.log(1.0 / delta_slack) * eps_sq_sum) + linear_sum


def advanced_composition(
    eps_per_round: float, rounds: int, delta_slack: float = DELTA_SLACK
) -> tuple[float, float]:
    """Strong composition of ``rounds`` (eps, 0)-DP rounds; ``(0, 0)`` for
    ``rounds <= 0``."""
    if rounds <= 0:
        return 0.0, 0.0
    eps = eps_per_round
    eps_total = float(
        strong_composition(
            rounds * (eps * eps), rounds * (eps * math.expm1(eps)), delta_slack
        )
    )
    return eps_total, delta_slack


def rounds_for_budget(
    eps_budget: float, eps_per_round: float, delta_slack: float = DELTA_SLACK
) -> int:
    """Largest T whose advanced composition stays within ``eps_budget``."""
    if eps_per_round <= 0.0:
        raise ValueError(
            f"eps_per_round must be > 0, got {eps_per_round} (with DP "
            "disabled every budget allows unboundedly many rounds)"
        )
    if advanced_composition(eps_per_round, 1, delta_slack)[0] > eps_budget:
        return 0
    t = 1
    while advanced_composition(eps_per_round, t + 1, delta_slack)[0] <= eps_budget:
        t += 1
        if t > 10_000_000:
            break
    return t
