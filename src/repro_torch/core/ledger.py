"""Privacy ledger: cumulative DP accounting across executed FL rounds.

The paper's Theorem 3 makes each round an ``(eps, 0)``-DP local
randomizer; what the *run* spends is a composition question. This module
(a copy of ``repro/core/ledger.py``; host-side numpy, so it ports as it
is) is the bookkeeping layer on top of the per-round math in
:mod:`repro_torch.core.privacy`: a :class:`PrivacyLedger` records one
:class:`DPEvent` per executed round and reports the cumulative budget
under four interchangeable accountants:

``basic``
    Pure sequential composition: ``eps_total = sum_t eps_t`` with
    ``delta = 0``. This is the conservative number the runtime reported
    before the ledger existed.

``advanced``
    Dwork-Rothblum-Vadhan strong composition (heterogeneous form)::

        eps' = sqrt(2 ln(1/delta') * sum_t eps_t^2)
               + sum_t eps_t * (e^{eps_t} - 1)

    at a ``delta_slack`` failure probability. Degenerate identity:
    zero recorded rounds report exactly ``eps' = 0``.

``subsampled``
    Amplification by subsampling: a round that samples each client with
    rate ``q`` (Poisson sampling, or uniform without-replacement
    sampling of ``m = q*M`` clients — both qualify for the pure-DP
    bound, see :func:`amplified_epsilon`) costs only::

        eps'_t = ln(1 + q * (e^{eps_t} - 1))  <  eps_t   for q < 1,

    composed sequentially (so the total stays pure ``(eps, 0)``-DP).
    Degenerate identity: ``q = 1`` is *bit-identical* to ``basic`` —
    the amplification map is short-circuited, never round-tripped
    through ``log``/``exp`` — so full participation reproduces the
    pre-ledger conservative numbers exactly.

``renyi``
    Rényi (moments) accountant. Each ``(eps, 0)``-DP round is dominated
    by eps-randomized response, whose *exact* Rényi divergence at order
    ``alpha`` is (:func:`rr_renyi_divergence`)::

        rdp(alpha) = log(p^alpha q^(1-alpha) + q^alpha p^(1-alpha))
                     / (alpha - 1),    p = e^eps/(1+e^eps), q = 1 - p

    Rounds compose by *summing* rdp per order; the total converts to
    ``(eps, delta_slack)``-DP with the improved RDP->DP conversion
    [Canonne-Kamath-Steinke 2020], minimized over an order grid and
    capped by the pure ``alpha -> inf`` endpoint (= basic composition).
    Dominance: the reported eps is ``<=`` both ``basic`` and
    ``advanced`` on every multi-round trajectory (property-tested) —
    this is the accountant that tightens the ``eps ~ 0.1`` multi-round
    regime beyond DRV.

Accountant API
--------------
``PrivacyLedger(eps_per_round, q, accountant)`` fixes the homogeneous
per-round parameters; :meth:`PrivacyLedger.record_round` appends events
as rounds execute; :attr:`PrivacyLedger.eps_spent` /
:attr:`PrivacyLedger.delta_spent` give the cumulative budget, and
:meth:`PrivacyLedger.trajectory` the closed-form cumulative-eps curve
for rounds ``1..T`` (what the campaign engine attaches as the
``eps_spent`` metric). :meth:`PrivacyLedger.report` evaluates all four
accountants side by side on the same event log. Heterogeneous events
(per-round ``eps``/``q`` overrides, e.g. an adaptive-clipping schedule)
go through :meth:`PrivacyLedger.record`.

Everything here is host-side ``math``/``numpy`` — accounting never
touches the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from .privacy import DELTA_SLACK, strong_composition

__all__ = [
    "ACCOUNTANTS",
    "DPEvent",
    "amplified_epsilon",
    "subsampled_composition",
    "rr_renyi_divergence",
    "renyi_epsilon",
    "PrivacyLedger",
]

ACCOUNTANTS = ("basic", "advanced", "subsampled", "renyi")

# Rényi order grid for the "renyi" accountant: log-spaced just above 1 up
# to 1e6, wide enough that the optimal order for any (eps, T) pair in the
# paper's regimes (eps in [1e-4, ~5], T up to ~1e5) lies strictly inside.
_ALPHA_GRID = 1.0 + np.logspace(-4.0, 6.0, 600)


def rr_renyi_divergence(eps: float, alpha: np.ndarray) -> np.ndarray:
    """Exact RDP curve of eps-randomized response at orders ``alpha``.

    Randomized response is the dominating pair for *any* pure
    ``(eps, 0)``-DP mechanism, so this curve is a valid per-round RDP
    bound for Theorem 3's one-bit randomizer. Computed in log space::

        rdp(alpha) = logaddexp(alpha*log p + (1-alpha)*log q,
                               alpha*log q + (1-alpha)*log p) / (alpha-1)

    with ``p = e^eps / (1 + e^eps)``. Limits: 0 at ``eps = 0``; tends to
    ``eps`` as ``alpha -> inf``; ~``alpha * eps^2 / 2`` for small eps.
    """
    alpha = np.asarray(alpha, np.float64)
    if eps <= 0.0:
        return np.zeros_like(alpha)
    log_p = -np.logaddexp(0.0, -eps)  # log sigmoid(eps)
    log_q = -np.logaddexp(0.0, eps)
    t1 = alpha * log_p + (1.0 - alpha) * log_q
    t2 = alpha * log_q + (1.0 - alpha) * log_p
    return np.logaddexp(t1, t2) / (alpha - 1.0)


def renyi_epsilon(
    rdp_total: np.ndarray, delta: float, basic_cap: np.ndarray | float
) -> np.ndarray | float:
    """Convert composed RDP totals to ``(eps, delta)``-DP.

    ``rdp_total`` holds the summed per-order RDP of the composition,
    shape ``(..., len(alpha_grid))``; the conversion is the improved
    RDP->DP bound [Canonne-Kamath-Steinke 2020]::

        eps = rdp(alpha) + log((alpha-1)/alpha) - (log delta + log alpha)/(alpha-1)

    minimized over the order grid, floored at 0, and finally min'ed with
    ``basic_cap`` — the exact ``alpha -> inf`` endpoint of the RR curve,
    i.e. pure sequential composition, which keeps the reported eps
    ``<= basic`` everywhere (including ``eps_per_round = 0`` -> 0).
    """
    alpha = _ALPHA_GRID
    conv = (
        rdp_total
        + np.log1p(-1.0 / alpha)
        - (math.log(delta) + np.log(alpha)) / (alpha - 1.0)
    )
    eps = np.maximum(conv.min(axis=-1), 0.0)
    return np.minimum(eps, basic_cap)


@dataclasses.dataclass(frozen=True)
class DPEvent:
    """One executed round's privacy parameters.

    ``epsilon`` is the full-participation per-round pure-DP cost
    (Theorem 3); ``q`` the client sampling rate of that round.
    """

    epsilon: float
    q: float = 1.0


def amplified_epsilon(eps: float, q: float) -> float:
    """Per-round eps after amplification by subsampling at rate ``q``.

    For a pure ``(eps, 0)``-DP mechanism run on a random subsample that
    includes each client with probability ``q``, the subsampled mechanism
    is ``(ln(1 + q*(e^eps - 1)), 0)``-DP. The bound holds for Poisson
    sampling and for uniform without-replacement sampling of ``m = q*M``
    of ``M`` clients [Balle-Barthe-Gaboardi 2018; Li et al. 2012] — the
    reference runtime's without-replacement cohort is the latter, so
    ``q = m_sampled / n_clients`` qualifies.

    Identities (relied on by the ledger and property-tested):

    * ``q >= 1`` returns ``eps`` **bit-identically** (short-circuit — no
      ``log1p(expm1(eps))`` float drift), so full participation matches
      the unamplified accounting exactly;
    * ``q <= 0`` or ``eps <= 0`` returns ``0.0``;
    * ``0 < q < 1`` gives ``0 < eps' < eps`` (strict tightening).
    """
    if eps <= 0.0:
        return 0.0
    if q >= 1.0:
        return float(eps)
    if q <= 0.0:
        return 0.0
    return math.log1p(q * math.expm1(eps))


def subsampled_composition(eps_per_round: float, rounds: int, q: float) -> float:
    """Sequential composition of ``rounds`` subsampled ``(eps, 0)`` rounds."""
    if rounds <= 0:
        return 0.0
    return amplified_epsilon(eps_per_round, q) * rounds


class PrivacyLedger:
    """Cumulative DP budget of an FL run, one event per executed round.

    Parameters fix the *homogeneous* per-round cost — ``eps_per_round``
    (Theorem 3's per-round eps; ``<= 0`` means DP disabled and every
    report is 0), the sampling rate ``q``, the ``accountant`` (one of
    :data:`ACCOUNTANTS`), and the ``delta_slack`` spent by the advanced
    accountant. Rounds are appended with :meth:`record_round`;
    :attr:`eps_spent` is the composed total under the configured
    accountant.
    """

    def __init__(
        self,
        eps_per_round: float,
        q: float = 1.0,
        accountant: str = "subsampled",
        delta_slack: float = DELTA_SLACK,
    ):
        if accountant not in ACCOUNTANTS:
            raise ValueError(
                f"unknown accountant {accountant!r}; available: {ACCOUNTANTS}"
            )
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"sampling rate q must be in [0, 1], got {q}")
        if not 0.0 < delta_slack < 1.0:
            raise ValueError(f"delta_slack must be in (0, 1), got {delta_slack}")
        self.eps_per_round_raw = max(float(eps_per_round), 0.0)
        self.q = float(q)
        self.accountant = accountant
        self.delta_slack = float(delta_slack)
        self._events: list[DPEvent] = []

    # -- event log -----------------------------------------------------------

    def record_round(self, n: int = 1) -> None:
        """Append ``n`` executed rounds at the configured (eps, q)."""
        self._events.extend(
            DPEvent(self.eps_per_round_raw, self.q) for _ in range(n)
        )

    def record(self, epsilon: float, q: float | None = None) -> None:
        """Append one round with explicit parameters (heterogeneous path),
        validated like the constructor's (negative eps clamps to 0)."""
        q = self.q if q is None else float(q)
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"sampling rate q must be in [0, 1], got {q}")
        self._events.append(DPEvent(max(float(epsilon), 0.0), q))

    @property
    def events(self) -> tuple[DPEvent, ...]:
        return tuple(self._events)

    @property
    def _homogeneous(self) -> bool:
        """True iff every recorded event carries the configured (eps, q)."""
        return all(
            e.epsilon == self.eps_per_round_raw and e.q == self.q
            for e in self._events
        )

    @property
    def rounds(self) -> int:
        return len(self._events)

    # -- per-round cost ------------------------------------------------------

    @property
    def per_round_epsilon(self) -> float:
        """The per-round eps the configured accountant composes over:
        amplified under ``subsampled``, raw otherwise."""
        if self.accountant == "subsampled":
            return amplified_epsilon(self.eps_per_round_raw, self.q)
        return self.eps_per_round_raw

    # -- composition ---------------------------------------------------------

    def compose(
        self,
        accountant: str | None = None,
        events: Sequence[DPEvent] | None = None,
    ) -> tuple[float, float]:
        """(eps_total, delta_total) of ``events`` (default: the recorded log).

        ``fsum`` keeps the homogeneous event log bit-identical to the
        closed forms in :meth:`trajectory` (the correctly-rounded sum of
        ``t`` copies of ``x`` equals the float product ``t * x``).
        """
        acc = accountant or self.accountant
        if acc not in ACCOUNTANTS:
            raise ValueError(
                f"unknown accountant {acc!r}; available: {ACCOUNTANTS}"
            )
        ev = self._events if events is None else list(events)
        if not ev:
            return 0.0, 0.0
        if acc == "basic":
            return math.fsum(e.epsilon for e in ev), 0.0
        if acc == "subsampled":
            return math.fsum(amplified_epsilon(e.epsilon, e.q) for e in ev), 0.0
        if acc == "renyi":
            if all(e.epsilon <= 0.0 for e in ev):
                return 0.0, 0.0
            # Per-order fsum: for a homogeneous log the correctly-rounded
            # sum of t equal curves is the float product t * rdp, keeping
            # this bit-identical to the closed form in trajectory().
            curves = np.stack(
                [rr_renyi_divergence(e.epsilon, _ALPHA_GRID) for e in ev]
            )
            rdp_tot = np.asarray([math.fsum(col) for col in curves.T])
            basic = math.fsum(e.epsilon for e in ev)
            return (
                float(renyi_epsilon(rdp_tot, self.delta_slack, basic)),
                self.delta_slack,
            )
        # advanced: heterogeneous Dwork-Rothblum-Vadhan strong composition
        s2 = math.fsum(e.epsilon * e.epsilon for e in ev)
        lin = math.fsum(e.epsilon * math.expm1(e.epsilon) for e in ev)
        return float(strong_composition(s2, lin, self.delta_slack)), self.delta_slack

    @property
    def eps_spent(self) -> float:
        return self.compose()[0]

    @property
    def delta_spent(self) -> float:
        return self.compose()[1]

    def eps_at(self, rounds: int, accountant: str | None = None) -> float:
        """Closed-form cumulative eps after ``rounds`` homogeneous rounds
        (no recording needed — what ``rounds`` events *would* cost)."""
        if rounds <= 0:
            return 0.0
        return float(self.trajectory(rounds, accountant)[-1])

    def trajectory(
        self, rounds: int | None = None, accountant: str | None = None
    ) -> np.ndarray:
        """Cumulative-eps curve after rounds ``1..T`` (float64, shape (T,)).

        An explicit ``rounds`` gives the *hypothetical* homogeneous
        closed form — what ``T`` rounds at the configured (eps, q) would
        cost — bit-identical to recording ``T`` such events and composing
        (see :meth:`compose`); the campaign engine attaches this as the
        per-round ``eps_spent`` metric. With ``rounds=None`` the curve
        follows the *recorded* log: a heterogeneous log (per-round
        :meth:`record` overrides) composes each prefix exactly, so the
        last point always equals :attr:`eps_spent`.
        """
        acc = accountant or self.accountant
        if acc not in ACCOUNTANTS:
            raise ValueError(
                f"unknown accountant {acc!r}; available: {ACCOUNTANTS}"
            )
        if rounds is None and not self._homogeneous:
            ev = self._events
            return np.asarray(
                [self.compose(acc, ev[:k])[0] for k in range(1, len(ev) + 1)]
            )
        T = self.rounds if rounds is None else int(rounds)
        t = np.arange(1, T + 1, dtype=np.float64)
        eps = self.eps_per_round_raw
        if acc == "advanced":
            return strong_composition(
                t * (eps * eps), t * (eps * math.expm1(eps)), self.delta_slack
            )
        if acc == "renyi":
            if eps <= 0.0:
                return np.zeros_like(t)
            # t copies of one RDP curve compose to t * rdp (fsum of equal
            # terms is the float product, matching compose() bit-for-bit).
            rdp_t = t[:, None] * rr_renyi_divergence(eps, _ALPHA_GRID)[None, :]
            return np.asarray(renyi_epsilon(rdp_t, self.delta_slack, eps * t))
        per = amplified_epsilon(eps, self.q) if acc == "subsampled" else eps
        return per * t

    def report(self) -> dict[str, dict[str, float]]:
        """All four accountants evaluated on the same event log."""
        out = {}
        for acc in ACCOUNTANTS:
            eps, delta = self.compose(acc)
            out[acc] = {"eps": eps, "delta": delta}
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"PrivacyLedger(eps_per_round={self.eps_per_round_raw}, q={self.q}, "
            f"accountant={self.accountant!r}, rounds={self.rounds}, "
            f"eps_spent={self.eps_spent:.6g})"
        )
