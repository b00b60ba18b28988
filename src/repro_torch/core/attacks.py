"""Byzantine attacks (paper §VI-D) on the stacked ``(M, d)`` updates.

Counterpart of ``repro/core/attacks.py``. Each delta-level attack rewrites
the first ``n_byz`` rows; bit schemes then compress the malicious rows with
the honest quantizer, whose clipping is the paper's amplitude immunity.
``bit_flip`` is a no-op at the delta level and instead inverts the first
``n_byz`` rows of the packed wire, or negates them on a dense wire
(:func:`flip_wire`).

Every attack takes ``(key, updates, n_byz)``; only ``gaussian`` draws, from
the port's bit-exact :func:`repro_torch.prng.normal`. The means of
``zero_gradient``, ``alie`` and ``ipm`` are sums times the f32 reciprocal
of the count, as the reference computes them under ``jit``.
"""

from __future__ import annotations

import dataclasses
import functools
import statistics
from typing import Callable

import torch

from .. import prng
from .aggregation import DenseWire, mean_rows, recip32

__all__ = [
    "alie_z",
    "ATTACK_IDS",
    "ATTACKS",
    "WIRE_ATTACKS",
    "TIMING_ATTACKS",
    "attack_id",
    "is_wire_attack",
    "is_timing_attack",
    "parse_attack",
    "apply_attack",
    "flip_wire",
]


def _set_byz(updates, n_byz, rows):
    out = updates.clone()
    out[:n_byz] = rows
    return out


def _no_attack(key, updates, n_byz):
    return updates


def _gaussian(key, updates, n_byz):
    """Each Byzantine uploads i.i.d. N(0, 100) (sigma = 10), drawn at the
    true width: the flat index counts over ``n_byz * d``."""
    return _set_byz(updates, n_byz, prng.normal(key, (n_byz, updates.shape[1]), scale=10.0))


def _sign_flip(key, updates, n_byz):
    """Scale the honest update by -5."""
    return _set_byz(updates, n_byz, -5.0 * updates[:n_byz])


def _zero_gradient(key, updates, n_byz):
    """Colluding: every Byzantine sends the value that zeroes the sum."""
    return _set_byz(updates, n_byz, -updates[n_byz:].sum(0) * recip32(max(n_byz, 1)))


def _sample_duplicate(key, updates, n_byz):
    """Every Byzantine replicates the first honest client's update."""
    return _set_byz(updates, n_byz, updates[n_byz])


@functools.lru_cache(maxsize=None)
def alie_z(n: int, n_byz: int) -> float:
    """The ALIE perturbation size ``z`` (Baruch et al. 2019): with ``n``
    workers of which ``n_byz`` collude, ``s = floor(n/2 + 1) - n_byz``
    honest supporters are needed and ``z = Phi^-1((n - n_byz - s) /
    (n - n_byz))``; a quantile at or below 1/2 (the breakdown point is not
    reached) or ``n_byz = 0`` gives ``z = 0``."""
    if n_byz <= 0 or n - n_byz <= 0:
        return 0.0
    s = n // 2 + 1 - n_byz
    frac = (n - n_byz - s) / (n - n_byz)
    if frac <= 0.5:
        return 0.0
    frac = min(frac, 1.0 - 1e-9)
    return float(statistics.NormalDist().inv_cdf(frac))


def _alie(key, updates, n_byz):
    """ALIE: ``mean - z * std`` of the honest updates (``std`` with
    ``ddof = 0``, as ``jnp.std``), ``z`` from :func:`alie_z`."""
    honest = updates[n_byz:]
    mu = mean_rows(honest)
    sigma = torch.sqrt(mean_rows((honest - mu) ** 2))
    return _set_byz(updates, n_byz, mu - alie_z(updates.shape[0], n_byz) * sigma)


def _ipm(key, updates, n_byz):
    """Inner-product manipulation: the honest mean scaled by -1.1."""
    return _set_byz(updates, n_byz, -1.1 * mean_rows(updates[n_byz:]))


# Delta-level ids in the reference's order (its lax.switch branch order).
ATTACK_IDS: tuple[str, ...] = (
    "none",
    "gaussian",
    "sign_flip",
    "zero_gradient",
    "sample_duplicate",
    "alie",
    "ipm",
)

ATTACKS: dict[str, Callable] = {
    "none": _no_attack,
    "gaussian": _gaussian,
    "sign_flip": _sign_flip,
    "zero_gradient": _zero_gradient,
    "sample_duplicate": _sample_duplicate,
    "alie": _alie,
    "ipm": _ipm,
    "bit_flip": _no_attack,  # wire-level: the pipeline flips the wire
}

WIRE_ATTACKS: frozenset[str] = frozenset({"bit_flip"})
TIMING_ATTACKS: frozenset[str] = frozenset({"straggler"})
_TIMING_PREFIX = "straggler+"


def parse_attack(name: str) -> tuple[str, bool]:
    """Split an attack name into ``(payload, straggler)``, as the reference
    does; raises ``ValueError`` on a name the reference does not know."""
    if name in TIMING_ATTACKS:
        return "none", True
    if name.startswith(_TIMING_PREFIX):
        payload = name[len(_TIMING_PREFIX):]
        if payload == "none" or payload not in ATTACKS:
            raise ValueError(f"unknown straggler payload {payload!r}")
        return payload, True
    if name not in ATTACKS:
        raise ValueError(f"unknown attack {name!r}; known: {tuple(sorted(ATTACKS))}")
    return name, False


def attack_id(name: str) -> int:
    """Integer id of the delta-level stage of ``name``."""
    payload, _ = parse_attack(name)
    return ATTACK_IDS.index("none" if payload in WIRE_ATTACKS else payload)


def is_wire_attack(name: str) -> bool:
    return parse_attack(name)[0] in WIRE_ATTACKS


def is_timing_attack(name: str) -> bool:
    return parse_attack(name)[1]


def apply_attack(idx: int, key: torch.Tensor, updates: torch.Tensor, n_byz: int) -> torch.Tensor:
    """``ATTACKS[ATTACK_IDS[idx]](key, updates, n_byz)``; returns a new
    tensor for every attack that rewrites rows."""
    if n_byz == 0:
        return updates
    return ATTACKS[ATTACK_IDS[idx]](key, updates, n_byz)


def flip_wire(wire, n_byz: int):
    """The ``bit_flip`` attack: invert every bit of the first ``n_byz``
    packed rows (pad bits flip too; every consumer slices the estimate to
    the true dimension, so they are inert), or negate the first ``n_byz``
    rows of a dense wire."""
    if isinstance(wire, DenseWire):
        return DenseWire(updates=_set_byz(wire.updates, n_byz, -wire.updates[:n_byz]))
    return dataclasses.replace(wire, packed=_set_byz(wire.packed, n_byz, torch.bitwise_not(wire.packed[:n_byz])))
