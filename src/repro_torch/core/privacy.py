"""Differential-privacy configuration and composition (paper Theorem 3).

Counterpart of ``repro/core/privacy.py`` for the one-bit wire. The
compressor of Eq. 5 is a local randomizer; it is ``(eps, 0)``-DP per round
when the public range satisfies

    b_i >= max_m |delta_i^m| + (1 + 1/eps) * Delta_1

The k-bit wire earns the same per-round (eps, 0) guarantee from L-level
randomized response instead (:func:`rr_gamma`); :func:`privacy_loss`
measures a mechanism's worst-case log-likelihood ratio between two
adjacent updates, one bit or k bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import prng
from .quantizer import WIRE_BITS, _grid_step, binarize_prob, level_probs

__all__ = [
    "DPConfig",
    "DELTA_SLACK",
    "dp_b_floor",
    "rr_gamma",
    "privacy_loss",
    "basic_composition",
    "strong_composition",
    "advanced_composition",
    "rounds_for_budget",
]

# Failure probability spent by the advanced (DRV) accountant.
DELTA_SLACK = 1e-5

# Clamps of the empirical log-likelihood ratio at the edges of the f32
# probability grid: only the deterministic endpoints (|delta| == b) reach
# them, which then report a finite sentinel instead of infinity.
_P_MIN = 2.0**-25
_P_MAX = 1.0 - 2.0**-24


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


def rr_gamma(epsilon, l1_sensitivity, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Uniform-mixing weight of the L-level randomized-response wire:
    ``gamma = L Delta_1 / (L Delta_1 + eps * step)`` with ``step =
    2b/(L-1)``, so that every level has probability at least ``gamma/L``
    and the per-round log-ratio stays within ``eps``.

    Computed as the reference is under ``jit``: ``step = 2b * f32(1/(L-1))``
    and the denominator one fused multiply-add ``fma(eps, max(step, 1e-30),
    L Delta_1)`` (XLA contracts it), divided as tensors. ``epsilon`` and
    ``l1_sensitivity`` are numbers (rounded to f32 first, as the reference
    converts them).
    """
    if bits not in WIRE_BITS:
        raise ValueError(f"bits must be one of {WIRE_BITS}, got {bits}")
    n_levels = 1 << bits
    b = torch.as_tensor(b, dtype=torch.float32)
    num = float(np.float32(n_levels) * np.float32(l1_sensitivity))
    step = torch.clamp(_grid_step(b, bits), min=1e-30)
    den = prng._fma(float(np.float32(epsilon)), step, num)
    return torch.full_like(den, num) / den


def privacy_loss(
    delta_a: torch.Tensor,
    delta_b: torch.Tensor,
    b: torch.Tensor,
    *,
    bits: int = 1,
    gamma: torch.Tensor | None = None,
) -> torch.Tensor:
    """Worst-case total log-likelihood ratio between two adjacent updates:
    over the coordinates, the sum of ``max_c |ln P(c|delta_a) - ln
    P(c|delta_b)|``. At one bit the outcomes are Eq. 5's two codes; at
    ``bits > 1`` the L levels of the adjacent-level tent
    (:func:`~repro_torch.core.quantizer.level_probs`), mixed with the
    uniform level when ``gamma`` is given. Probabilities are clamped to
    ``[_P_MIN, _P_MAX]`` before the logs (not the mixed ones, which are
    at least ``gamma / L``)."""
    if bits == 1 and gamma is None:
        pa = torch.clamp(binarize_prob(delta_a, b), _P_MIN, _P_MAX)
        pb = torch.clamp(binarize_prob(delta_b, b), _P_MIN, _P_MAX)
        loss_plus = (torch.log(pa) - torch.log(pb)).abs()
        loss_minus = (torch.log1p(-pa) - torch.log1p(-pb)).abs()
        return torch.maximum(loss_plus, loss_minus).sum()
    qa, qb = level_probs(delta_a, b, bits), level_probs(delta_b, b, bits)
    if gamma is None:
        pa, pb = torch.clamp(qa, _P_MIN, _P_MAX), torch.clamp(qb, _P_MIN, _P_MAX)
    else:
        g = torch.as_tensor(gamma, dtype=torch.float32)
        mix = g * (1.0 / (1 << bits))  # an exact power of two
        pa, pb = (1.0 - g) * qa + mix, (1.0 - g) * qb + mix
    return (torch.log(pa) - torch.log(pb)).abs().amax(0).sum()


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
