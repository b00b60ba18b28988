"""Logical-axis sharding policy and the client axis's collectives.

Counterpart of ``repro/distributed.py``. Model code names a tensor's axes
*logically*; this module maps the names onto whatever
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
is current (:func:`set_mesh`). Without a mesh every annotation is a no-op,
so the same model code runs on one device and on a mesh.

Logical -> mesh-dimension rules (the reference's):

  batch    -> ("pod", "data") when a pod axis exists, else ("data",)
  seq, heads, kv, ff, vocab, experts -> "model"
  clients  -> "pod"
  d / hd / conv / state / None -> replicated

An annotation is dropped when the tensor's dimension does not divide by
the mesh dimension's size (24 query heads on a 16-way model axis): the
tensor is replicated on it instead, and one mesh dimension serves at most
one tensor dimension. :func:`spec_for` returns the reference's
``PartitionSpec`` entries as a tuple; :func:`placements_for` turns them
into DTensor placements. Parameters do not become DTensors yet (the model
axis, ROADMAP A14b), so :func:`shard` redistributes only a DTensor.

The federated client axis (``stream_shard``, ``tree_shard``,
``run_campaign(shard=True)`` and the LM round's pod axis) is SPMD: one
process a rank, each building the same round from the same seeds, and the
only data that crosses ranks is the vote traffic, through
:func:`all_reduce_sum` and :func:`all_gather_rows` on the process group of
the current mesh's ``"data"`` dimension (:func:`client_group`), or of the
default group's whole world when no mesh is set. The backend is whatever
the caller started the group with. Gloo runs the collectives on host
memory, so a CUDA tensor crosses ranks through a host copy; NCCL takes
the card's memory as it is.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import time

import torch

__all__ = [
    "batch_axes",
    "use_rules",
    "use_batch_axes",
    "set_mesh",
    "current_mesh",
    "mesh_sizes",
    "spec_for",
    "placements_for",
    "shard",
    "client_group",
    "group_size",
    "group_rank",
    "all_reduce_sum",
    "all_gather_rows",
    "collectives",
    "reset_collectives",
]

# Which mesh dimensions carry the (token) batch. FL training multiplexes
# clients over "pod", so the batch spans only "data" there; serving spans both.
_BATCH_AXES: contextvars.ContextVar[tuple[str, ...]] = contextvars.ContextVar("repro_torch_batch_axes",
                                                                              default=("data",))
# Per-context overrides of the logical -> mesh rules (the reference's 2-D
# weight-stationary serving layout sets them).
_RULE_OVERRIDES: contextvars.ContextVar[dict] = contextvars.ContextVar("repro_torch_rule_overrides", default={})
_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)

# logical name -> candidate mesh dimensions (the first whose size divides
# the tensor's dimension wins; a mesh dimension is not split across names)
_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("data",),
    "batch_pod": ("pod", "data"),  # batch big enough for both axes
    "clients": ("pod",),
    "seq": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
}


def batch_axes() -> tuple[str, ...]:
    return _BATCH_AXES.get()


@contextlib.contextmanager
def use_rules(**overrides: tuple[str, ...]):
    tok = _RULE_OVERRIDES.set(dict(overrides))
    try:
        yield
    finally:
        _RULE_OVERRIDES.reset(tok)


@contextlib.contextmanager
def use_batch_axes(*axes: str):
    tok = _BATCH_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _BATCH_AXES.reset(tok)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None for none) the current mesh
    inside the ``with`` block."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    """The mesh of the innermost :func:`set_mesh`, or None."""
    return _MESH.get()


def mesh_sizes(mesh) -> dict[str, int]:
    """``{dimension name: size}`` of a mesh (anything with
    ``mesh_dim_names`` and ``shape``, as a ``DeviceMesh`` has)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_entry(mesh, name: str | None, dim: int, used: set[str]):
    if name is None or name not in _RULES:
        return None
    sizes = mesh_sizes(mesh)
    over = _RULE_OVERRIDES.get()
    if name in over:
        cand = over[name]
    elif name == "batch":
        cand = batch_axes()
    else:
        cand = _RULES[name]
    axes = [a for a in cand if a in sizes and a not in used]
    if not axes:
        return None
    prod = 1
    for a in axes:
        prod *= sizes[a]
    if dim % prod:
        # the single dimensions, in order
        for a in axes:
            if dim % sizes[a] == 0:
                return a
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def spec_for(logical: tuple[str | None, ...], shape: tuple[int, ...]) -> tuple:
    """The reference's ``PartitionSpec`` of a tensor with these logical axes
    and this shape on the current mesh, as a tuple: one entry a dimension,
    a mesh dimension's name, a tuple of names or None (``()`` without a
    mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    entries, used = [], set()
    for name, dim in zip(logical, shape):
        e = _axis_entry(mesh, name, dim, used)
        if e is not None:
            used.update(e if isinstance(e, tuple) else (e,))
        entries.append(e)
    return tuple(entries)


def placements_for(mesh, logical: tuple[str | None, ...], shape: tuple[int, ...]) -> tuple:
    """DTensor placements on ``mesh`` of a tensor with these logical axes:
    one a mesh dimension, ``Shard(i)`` where tensor dimension ``i`` takes
    it, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    with set_mesh(mesh):
        spec = spec_for(logical, shape)
    owner = {}
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                owner[a] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names)


def shard(x, *logical: str | None):
    """Lay ``x`` out by its logical axes on the current mesh: without a
    mesh, or for a plain tensor, ``x`` itself; a DTensor is redistributed."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical axes for a tensor of shape {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements_for(x.device_mesh, logical, tuple(x.shape)))


def client_group(dim: str = "data"):
    """The process group the client axis spreads over: the current mesh's
    ``dim`` dimension, else the default group's whole world; None when no
    process group was started."""
    import torch.distributed as dist

    mesh = current_mesh()
    if mesh is not None and dim in (mesh.mesh_dim_names or ()):
        return mesh.get_group(dim)
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for None)."""
    import torch.distributed as dist

    return 0 if group is None else dist.get_rank(group)


# This process's collectives since the last reset: "calls", the "bytes" it
# sent into them and the host "ms" they took (host copies included).
collectives: collections.Counter = collections.Counter()


def reset_collectives() -> None:
    collectives.clear()


def _count(x: torch.Tensor, t0: float) -> None:
    collectives["calls"] += 1
    collectives["bytes"] += x.numel() * x.element_size()
    collectives["ms"] += (time.perf_counter() - t0) * 1e3


def _staged(x: torch.Tensor, group) -> bool:
    """Does ``x`` cross ranks through a host copy (a CUDA tensor on gloo)?"""
    import torch.distributed as dist

    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on every rank (a new
    tensor on ``x``'s device)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = x.cpu() if _staged(x, group) else x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    out = buf.to(x.device)
    _count(x, t0)
    return out


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading axis in rank order,
    on every rank: ``(n, *x.shape)`` on ``x``'s device."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    src = x.contiguous().cpu() if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts).to(x.device)
    _count(x, t0)
    return out
