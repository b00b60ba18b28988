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

The streaming round sees one chunk of the cohort at a time, so it runs
only the attacks that rewrite a row from that row alone
(:data:`STREAM_ATTACKS`, :func:`apply_attack_stream`; the gaussian noise
is then drawn a row at a time, keyed by the row's cohort position) and
flips wire rows by a mask (:func:`flip_wire_rows`). The ``straggler``
timing attack acts in the asynchronous round's arrivals.

A hierarchical tree round adds Byzantine *edge aggregators*
(:data:`EDGE_ATTACK_IDS`, :func:`apply_edge_attack`): a compromised edge
ships a forged count tensor to the root, the per-plane complement
``mass - N`` (``edge_sign_flip``), every count at the full mass
(``edge_inflate``) or the tensor the root last buffered for its slot
(``edge_replay``). None changes the shipped mass, and every forged count
stays within ``[0, mass]``.
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
    "available_attacks",
    "get_attack",
    "apply_attack",
    "STREAM_ATTACKS",
    "apply_attack_stream",
    "flip_codes",
    "flip_wire",
    "flip_wire_rows",
    "EDGE_ATTACK_IDS",
    "edge_attack_id",
    "apply_edge_attack",
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
        raise ValueError(f"unknown attack {name!r}; available: {available_attacks()}")
    return name, False


def available_attacks() -> tuple[str, ...]:
    """Every accepted attack name, straggler compositions included, in the
    reference's order."""
    return tuple(sorted(ATTACKS)) + tuple(sorted(TIMING_ATTACKS)) + tuple(
        _TIMING_PREFIX + p for p in sorted(ATTACKS) if p != "none"
    )


def get_attack(name: str) -> Callable:
    """The delta-level ``attack(key, updates (M, d), n_byz) -> updates`` of
    ``name``: the identity for a wire attack (``bit_flip``: the pipeline
    flips the wire), the payload's stage for ``straggler+<payload>``."""
    payload, _ = parse_attack(name)
    return ATTACKS["none" if payload in WIRE_ATTACKS else payload]


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


# Attacks whose Byzantine rows depend on the row's own update and cohort
# position only; the colluding ones read the whole honest cohort.
STREAM_ATTACKS: frozenset[str] = frozenset({"none", "gaussian", "sign_flip", "bit_flip"})


def apply_attack_stream(idx: int, key: torch.Tensor, updates: torch.Tensor, n_byz: int, row0: int) -> torch.Tensor:
    """The delta-level attack on one ``(C, d)`` chunk whose rows are cohort
    positions ``row0 .. row0 + C - 1``; the Byzantines are the positions
    below ``n_byz``, as in the dense round. ``sign_flip`` scales their rows
    by -5 (the dense values); ``gaussian`` draws row ``r``'s noise as
    ``10 * normal(fold_in(key, r), (d,))``, so any chunking of the cohort
    draws the same noise (not the dense round's one blocked draw), with
    the factor 10 folded into the normal's ``sqrt(2)`` as under ``jit``
    (eager JAX rounds twice and differs in the last bit); every
    other id leaves the chunk as it is (the colluding attacks are rejected
    by the config). Only the Byzantine rows are drawn."""
    n = min(max(n_byz - row0, 0), updates.shape[0])
    name = ATTACK_IDS[idx]
    if n == 0 or name not in ("gaussian", "sign_flip"):
        return updates
    if name == "sign_flip":
        return _set_byz(updates, n, -5.0 * updates[:n])
    rows = torch.arange(row0, row0 + n, dtype=torch.int64, device=key.device)
    return _set_byz(updates, n, prng.normal(prng.fold_in(key, rows), (updates.shape[1],), scale=10.0))


def flip_codes(codes: torch.Tensor, n_byz: int) -> torch.Tensor:
    """The worst-case bit adversary on unpacked codes: a new tensor with the
    first ``n_byz`` clients' (rows') codes negated; ``codes`` is left as it
    is."""
    out = codes.clone()
    out[:n_byz] = -codes[:n_byz]
    return out


def flip_wire(wire, n_byz: int, runs=None):
    """The ``bit_flip`` attack: invert every bit of the first ``n_byz``
    packed rows (pad bits flip too; every consumer slices the estimate to
    the true dimension, so they are inert), or negate the first ``n_byz``
    rows of a dense wire. On a group's wire, the first ``n_byz`` rows of
    each run (element) listed in ``runs``."""
    if runs is not None:
        dense = isinstance(wire, DenseWire)
        out = (wire.updates if dense else wire.packed).clone()
        for e in runs:
            byz = out[e, :n_byz]
            byz.copy_(-byz if dense else torch.bitwise_not(byz))
        return DenseWire(updates=out) if dense else dataclasses.replace(wire, packed=out)
    if isinstance(wire, DenseWire):
        return DenseWire(updates=_set_byz(wire.updates, n_byz, -wire.updates[:n_byz]))
    return dataclasses.replace(wire, packed=_set_byz(wire.packed, n_byz, torch.bitwise_not(wire.packed[:n_byz])))


def flip_wire_rows(wire, row_mask: torch.Tensor, runs=None):
    """:func:`flip_wire` on the rows where ``row_mask`` is True: the
    streaming round's chunks straddle the Byzantine boundary. On a group's
    wire, those rows of each run (element) listed in ``runs``."""
    mask = row_mask[:, None]
    if runs is not None:
        dense = isinstance(wire, DenseWire)
        out = (wire.updates if dense else wire.packed).clone()
        for e in runs:
            out[e] = torch.where(mask, -out[e] if dense else torch.bitwise_not(out[e]), out[e])
        return DenseWire(updates=out) if dense else dataclasses.replace(wire, packed=out)
    if isinstance(wire, DenseWire):
        return DenseWire(updates=torch.where(mask, -wire.updates, wire.updates))
    return dataclasses.replace(wire, packed=torch.where(mask, torch.bitwise_not(wire.packed), wire.packed))


# Edge attacks in the reference's order (its lax.switch branch order).
EDGE_ATTACK_IDS: tuple[str, ...] = ("none", "edge_sign_flip", "edge_inflate", "edge_replay")


def edge_attack_id(name: str) -> int:
    """Integer id of an edge-aggregator attack."""
    if name not in EDGE_ATTACK_IDS:
        raise ValueError(f"unknown edge attack {name!r}; available: {EDGE_ATTACK_IDS}")
    return EDGE_ATTACK_IDS.index(name)


def apply_edge_attack(idx: int, counts: torch.Tensor, mass: torch.Tensor, prev_counts: torch.Tensor,
                      prev_mass: torch.Tensor, prev_valid: torch.Tensor, byz_mask: torch.Tensor):
    """Rewrite the Byzantine edges' shipped ``(E, 8P)`` f32 counts and
    ``(E,)`` masses before the root merge; ``prev_*`` is what the root's
    buffer held for each edge's slot before this round's deliveries, and
    ``byz_mask`` (E,) marks the compromised edges. Honest edges pass
    through untouched. A campaign group's tensors carry its runs before
    the edge axis, ``(R, E, 8P)`` and ``(R, E)``."""
    name = EDGE_ATTACK_IDS[idx]
    if name == "edge_sign_flip":
        c_att, m_att = mass.unsqueeze(-1) - counts, mass
    elif name == "edge_inflate":
        c_att, m_att = torch.broadcast_to(mass.unsqueeze(-1), counts.shape), mass
    elif name == "edge_replay":
        c_att = torch.where(prev_valid.unsqueeze(-1), prev_counts, counts)
        m_att = torch.where(prev_valid, prev_mass, mass)
    else:
        return counts, mass
    return torch.where(byz_mask.unsqueeze(-1), c_att, counts), torch.where(byz_mask, m_att, mass)
