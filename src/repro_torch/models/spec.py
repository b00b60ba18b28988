"""Parameter-spec trees: one definition drives init and the parameter count.

Counterpart of ``repro/models/spec.py``. A model's parameters are a tree
(nested dicts and lists, :mod:`repro_torch.tree`) of :class:`LeafSpec`;
:func:`init_params` materializes it with the reference's draws, bit for
bit. The reference's sharding helpers (``param_pspecs``,
``abstract_params``) come with the model axis (ROADMAP A14b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import prng
from ..tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["LeafSpec", "stack_specs", "init_params", "count_params"]

# Flat elements a normal draw takes at a time: f64 temporaries of 256 MiB.
INIT_BLOCK = 1 << 25


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = -1.0  # -1 -> 1/sqrt(fan_in) with fan_in = shape[-2] or [-1]
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, LeafSpec)


def stack_specs(tree, reps: int):
    """Prepend a layer-stacking dim (replicated) to every LeafSpec."""
    return tree_map(
        lambda s: LeafSpec((reps,) + s.shape, (None,) + s.logical, s.init, s.scale, s.dtype), tree, is_leaf=is_spec
    )


def _normal_leaf(k: torch.Tensor, s: LeafSpec, scale: float) -> torch.Tensor:
    """``(scale * normal(k, shape, f32)).astype(dtype)``, drawn
    :data:`INIT_BLOCK` flat elements at a time (the stream continues across
    blocks, so the bits are the whole draw's)."""
    n = math.prod(s.shape)
    out = torch.empty((n,), dtype=s.dtype, device=k.device)
    for i0 in range(0, n, INIT_BLOCK):
        i1 = min(i0 + INIT_BLOCK, n)
        out[i0:i1] = (prng.normal(k, (i1 - i0,), offset=i0) * scale).to(s.dtype)
    return out.view(s.shape)


def init_params(tree, key: torch.Tensor):
    """Materialize the tree on ``key``'s device: leaf ``i`` in flatten order
    is zeros, ones, or ``scale * normal(fold_in(key, i), shape)`` in f32
    (the reference's eager multiply, one f32 rounding) rounded to the
    leaf's dtype, with ``scale = 1/sqrt(fan_in)`` unless given."""

    def make(i: int, s: LeafSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=key.device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=key.device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        scale = s.scale if s.scale > 0 else fan_in**-0.5
        return _normal_leaf(prng.fold_in(key, i), s, scale)

    vals = [make(i, s) for i, (_, s) in enumerate(leaves_with_path(tree, is_leaf=is_spec))]
    return unflatten(tree, vals, is_leaf=is_spec)


def count_params(tree) -> int:
    return sum(math.prod(s.shape) for s in leaves(tree, is_leaf=is_spec))
