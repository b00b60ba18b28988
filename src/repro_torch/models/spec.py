"""Parameter-spec trees: one definition drives init, abstract shapes (for
the allocation-free dry run) and sharding.

Counterpart of ``repro/models/spec.py``. A model's parameters are a tree
(nested dicts and lists, :mod:`repro_torch.tree`) of :class:`LeafSpec`;
from it come (a) meta tensors of every leaf (:func:`abstract_params`),
(b) the reference's ``PartitionSpec`` entries of every leaf on the current
mesh (:func:`param_pspecs`) and their DTensor placements
(:func:`param_placements`), and (c) the initial values
(:func:`init_params`), the reference's draws bit for bit, as DTensors
with those placements when a mesh is given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import distributed, prng
from ..tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["LeafSpec", "stack_specs", "abstract_params", "param_pspecs", "param_placements", "init_params",
           "count_params"]

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


def abstract_params(tree):
    """Meta tensors of every leaf's shape and dtype (nothing allocated)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree, is_leaf=is_spec)


def param_pspecs(tree, fsdp_axis: str | None = None):
    """The reference's ``PartitionSpec`` entries of every leaf on the
    current mesh, as tuples (:func:`repro_torch.distributed.spec_for`).

    ``fsdp_axis``: besides, shard each leaf's largest still-replicated
    dimension that the axis's size divides over that mesh dimension
    (ZeRO-3), ties going to the higher index, as the reference's
    ``max((dim, i))``. Without a mesh, or one without that dimension, the
    entries are the logical rules' alone.
    """
    base = tree_map(lambda s: distributed.spec_for(s.logical, s.shape), tree, is_leaf=is_spec)
    mesh = distributed.current_mesh()
    if fsdp_axis is None or mesh is None or fsdp_axis not in mesh.mesh_dim_names:
        return base
    size = distributed.mesh_sizes(mesh)[fsdp_axis]

    def add_fsdp(s: LeafSpec, spec: tuple) -> tuple:
        entries = list(spec) + [None] * (len(s.shape) - len(spec))
        cand = [(dim, i) for i, (dim, e) in enumerate(zip(s.shape, entries))
                if e is None and dim % size == 0 and dim >= size]
        if not cand:
            return spec
        entries[max(cand)[1]] = fsdp_axis
        return tuple(entries)

    return unflatten(tree, [add_fsdp(s, sp) for s, sp in zip(leaves(tree, is_leaf=is_spec), leaves(
        base, is_leaf=lambda x: isinstance(x, tuple)))], is_leaf=is_spec)


def param_placements(tree, mesh, fsdp_axis: str | None = None):
    """Every leaf's DTensor placements on ``mesh``: :func:`param_pspecs`
    (with the FSDP rule when ``fsdp_axis`` is given) on that mesh."""
    with distributed.set_mesh(mesh):
        specs = param_pspecs(tree, fsdp_axis)
    entries = leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
    return unflatten(tree, [distributed.placements_of(mesh, sp) for sp in entries], is_leaf=is_spec)


def _normal_leaf(k: torch.Tensor, s: LeafSpec, scale: float, local: tuple | None = None,
                 offset: tuple | None = None) -> torch.Tensor:
    """``(scale * normal(k, shape, f32)).astype(dtype)``, drawn
    :data:`INIT_BLOCK` flat elements at a time (the stream continues across
    blocks, so the bits are the whole draw's); with ``local`` and
    ``offset``, the shard of that shape at that offset, each coordinate
    drawn at its flat index in the whole leaf."""
    local = s.shape if local is None else tuple(local)
    n = math.prod(local)
    out = torch.empty((n,), dtype=s.dtype, device=k.device)
    for i0 in range(0, n, INIT_BLOCK):
        i1 = min(i0 + INIT_BLOCK, n)
        if offset is None:
            u = prng.normal(k, (i1 - i0,), offset=i0)
        else:
            u = prng.normal(k, (i1 - i0,), index=prng.shard_flat_index(s.shape, local, offset, i0, i1, k.device))
        out[i0:i1] = (u * scale).to(s.dtype)
    return out.view(local)


def _scale(s: LeafSpec) -> float:
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    return s.scale if s.scale > 0 else fan_in**-0.5



def init_params(tree, key: torch.Tensor, *, mesh=None, fsdp_axis: str | None = None):
    """Materialize the tree on ``key``'s device: leaf ``i`` in flatten order
    is zeros, ones, or ``scale * normal(fold_in(key, i), shape)`` in f32
    (the reference's eager multiply, one f32 rounding) rounded to the
    leaf's dtype, with ``scale = 1/sqrt(fan_in)`` unless given.

    With a ``mesh`` every leaf is a DTensor with :func:`param_placements`
    (``fsdp_axis`` as there): each rank draws only the coordinates of its
    shard, each from its flat index in the whole leaf's draw
    (``prng.normal(..., index=)``), so the values are the unsharded ones
    and no rank holds a whole leaf."""
    if mesh is not None:
        pl = leaves(param_placements(tree, mesh, fsdp_axis), is_leaf=lambda x: isinstance(x, tuple))
        vals = []
        for i, (s, p) in enumerate(zip(leaves(tree, is_leaf=is_spec), pl)):
            local, off = distributed.shard_bounds(s.shape, mesh, p)
            if s.init == "zeros":
                piece = torch.zeros(local, dtype=s.dtype, device=key.device)
            elif s.init == "ones":
                piece = torch.ones(local, dtype=s.dtype, device=key.device)
            else:
                piece = _normal_leaf(prng.fold_in(key, i), s, _scale(s), local, off)
            vals.append(distributed.from_shard(piece, mesh, p, s.shape))
        return unflatten(tree, vals, is_leaf=is_spec)

    def make(i: int, s: LeafSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=key.device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=key.device)
        return _normal_leaf(prng.fold_in(key, i), s, _scale(s))

    vals = [make(i, s) for i, (_, s) in enumerate(leaves_with_path(tree, is_leaf=is_spec))]
    return unflatten(tree, vals, is_leaf=is_spec)


def count_params(tree) -> int:
    return sum(math.prod(s.shape) for s in leaves(tree, is_leaf=is_spec))
