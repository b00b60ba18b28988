"""Byzantine attacks (paper §VI-D) on the stacked ``(M, d)`` updates.

Counterpart of ``repro/core/attacks.py``. Each delta-level attack rewrites
the first ``n_byz`` rows; bit schemes then compress the malicious rows with
the honest quantizer, whose clipping is the paper's amplitude immunity.
``bit_flip`` is a no-op at the delta level and instead inverts the first
``n_byz`` rows of the packed wire (:func:`flip_wire`).

This slice ports the attacks that draw nothing. ``gaussian`` needs
``normal`` and ``alie``/``ipm`` come with it (ROADMAP A7); the attack ids
keep the reference's numbering so a later slice only fills them in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = [
    "ATTACK_IDS",
    "ATTACKS",
    "UNPORTED_ATTACKS",
    "WIRE_ATTACKS",
    "TIMING_ATTACKS",
    "attack_id",
    "is_wire_attack",
    "is_timing_attack",
    "parse_attack",
    "apply_attack",
    "flip_wire",
]


def _no_attack(updates, n_byz):
    return updates


def _sign_flip(updates, n_byz):
    """Scale the honest update by -5."""
    out = updates.clone()
    out[:n_byz] = -5.0 * updates[:n_byz]
    return out


def _zero_gradient(updates, n_byz):
    """Colluding: every Byzantine sends the value that zeroes the sum."""
    out = updates.clone()
    out[:n_byz] = -updates[n_byz:].sum(0) / max(n_byz, 1)
    return out


def _sample_duplicate(updates, n_byz):
    """Every Byzantine replicates the first honest client's update."""
    out = updates.clone()
    out[:n_byz] = updates[n_byz]
    return out


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
    "sign_flip": _sign_flip,
    "zero_gradient": _zero_gradient,
    "sample_duplicate": _sample_duplicate,
    "bit_flip": _no_attack,  # wire-level: the pipeline flips packed codes
}

# Known to the reference, not yet ported: they draw from ``normal``.
UNPORTED_ATTACKS: frozenset[str] = frozenset({"gaussian", "alie", "ipm"})

WIRE_ATTACKS: frozenset[str] = frozenset({"bit_flip"})
TIMING_ATTACKS: frozenset[str] = frozenset({"straggler"})
_TIMING_PREFIX = "straggler+"


def parse_attack(name: str) -> tuple[str, bool]:
    """Split an attack name into ``(payload, straggler)``, as the reference
    does; raises ``ValueError`` on a name the reference does not know."""
    known = set(ATTACKS) | UNPORTED_ATTACKS
    if name in TIMING_ATTACKS:
        return "none", True
    if name.startswith(_TIMING_PREFIX):
        payload = name[len(_TIMING_PREFIX):]
        if payload == "none" or payload not in known:
            raise ValueError(f"unknown straggler payload {payload!r}")
        return payload, True
    if name not in known:
        raise ValueError(f"unknown attack {name!r}; known: {tuple(sorted(known))}")
    return name, False


def attack_id(name: str) -> int:
    """Integer id of the delta-level stage of ``name``."""
    payload, _ = parse_attack(name)
    return ATTACK_IDS.index("none" if payload in WIRE_ATTACKS else payload)


def is_wire_attack(name: str) -> bool:
    return parse_attack(name)[0] in WIRE_ATTACKS


def is_timing_attack(name: str) -> bool:
    return parse_attack(name)[1]


def apply_attack(idx: int, updates: torch.Tensor, n_byz: int) -> torch.Tensor:
    """``ATTACKS[ATTACK_IDS[idx]](updates, n_byz)``; returns a new tensor
    for every attack that rewrites rows."""
    name = ATTACK_IDS[idx]
    if name in UNPORTED_ATTACKS:
        raise NotImplementedError(f"attack {name!r} draws from normal (ROADMAP A7)")
    if n_byz == 0:
        return updates
    return ATTACKS[name](updates, n_byz)


def flip_wire(wire, n_byz: int):
    """The ``bit_flip`` attack: invert every bit of the first ``n_byz``
    packed rows. Pad bits flip too; every consumer slices the estimate to
    the true dimension, so they are inert."""
    packed = wire.packed.clone()
    packed[:n_byz] = torch.bitwise_not(packed[:n_byz])
    return dataclasses.replace(wire, packed=packed)
