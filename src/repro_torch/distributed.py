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
into DTensor placements. On the model axis the parameters are DTensors
(``models.spec.param_placements``) and the activations follow them;
:func:`shard` redistributes a DTensor to the placements of its logical
axes and leaves a plain tensor as it is. Where DTensor has no sharding
rule for what a mixer does (the MoE's sort, the Mamba scan, the sLSTM
step, the attention core), :func:`local_region` runs that region on each
rank's local shards (``local_map``, the counterpart of ``shard_map``).

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

DTensor issues its own collectives (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``) on the
process group of the mesh. Gloo takes some of them on CUDA tensors and not
others (on torch 2.11 its ``all_gather_into_tensor`` of a CUDA tensor ends
the process), and NCCL refuses two ranks on one card. So the ranks that
share one card start their group with the ``"staged"`` backend
(:data:`STAGED_BACKEND`, registered on import): a Python process group
that copies each CUDA tensor to the host, runs the collective on a gloo
group of the same ranks, and copies the result back; every collective it
runs is counted in :data:`collectives` (``"staged_calls"``,
``"staged_bytes"``, ``"staged_ms"``). Host tensors go to gloo as they are;
a group of one rank copies on the device and counts nothing.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
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
    "placements_of",
    "placements_for",
    "shard",
    "is_dtensor",
    "has_dtensors",
    "mesh_context",
    "local_region",
    "logical_region",
    "pointwise",
    "einsum",
    "shard_bounds",
    "from_shard",
    "keep_shard",
    "region_ranks",
    "counting_regions",
    "axis_rank",
    "client_group",
    "group_size",
    "group_rank",
    "all_reduce_sum",
    "all_gather_rows",
    "collectives",
    "reset_collectives",
    "STAGED_BACKEND",
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


def placements_of(mesh, spec: tuple) -> tuple:
    """DTensor placements on ``mesh`` of a tensor's spec entries (as
    :func:`spec_for` gives them): one a mesh dimension, ``Shard(i)`` where
    tensor dimension ``i`` takes it, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                owner[a] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names)


def placements_for(mesh, logical: tuple[str | None, ...], shape: tuple[int, ...]) -> tuple:
    """DTensor placements on ``mesh`` of a tensor with these logical axes
    (:func:`placements_of` its :func:`spec_for` on ``mesh``)."""
    with set_mesh(mesh):
        return placements_of(mesh, spec_for(logical, shape))


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


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def has_dtensors(tree) -> bool:
    """Does a tree (dicts and lists) hold a DTensor leaf?"""
    if isinstance(tree, dict):
        return any(has_dtensors(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_dtensors(v) for v in tree)
    return is_dtensor(tree)


def mesh_context(tree):
    """The context a model entry point runs in: for a tree of DTensors, the
    parameters' mesh made current (a training step's parameters live on
    the ("data", "model") part of a mesh whose "pod" dimension the client
    axis takes) and plain tensors (positions, masks) taken as replicated
    on it (``implicit_replication``); otherwise nothing."""
    from torch.distributed.tensor.experimental import implicit_replication

    from .tree import leaves

    if not has_dtensors(tree):
        return contextlib.nullcontext()
    mesh = next(x for x in leaves(tree) if is_dtensor(x)).device_mesh
    stack = contextlib.ExitStack()
    stack.enter_context(set_mesh(mesh))
    stack.enter_context(implicit_replication())
    return stack


# The ranks that a local region's distinct work is spread over inside
# :func:`local_region` (the product of the sizes of the mesh dimensions
# that shard an input; 1 outside): flop counting multiplies the region's
# local operations by it, so a region counts its global work once. While
# operations are counted (:func:`counting_regions`), the backward of a
# region's local operations runs with the same multiplier.
_REGION_RANKS: contextvars.ContextVar[int] = contextvars.ContextVar("repro_torch_region_ranks", default=1)
_COUNTING: contextvars.ContextVar[bool] = contextvars.ContextVar("repro_torch_counting", default=False)


def region_ranks() -> int:
    return _REGION_RANKS.get()


@contextlib.contextmanager
def counting_regions():
    """Mark the local regions' backward nodes with their multiplier (for a
    flop counter; nothing is marked otherwise)."""
    tok = _COUNTING.set(True)
    try:
        yield
    finally:
        _COUNTING.reset(tok)


def _mark_backward(outs, local_args, split: int) -> None:
    """Run each autograd node that a region's local operations made (from
    ``outs`` back to the region's ``local_args``) with the region's
    multiplier: a pre-hook sets it, a hook puts back what was there. A
    checkpoint's recomputation inside such a node runs in the forward's
    own context (``models.model._in_this_context``), so it is not
    multiplied."""
    stop = {a.grad_fn for a in local_args if isinstance(a, torch.Tensor) and a.grad_fn is not None}
    stack = [o.grad_fn for o in outs if isinstance(o, torch.Tensor) and o.grad_fn is not None]
    seen = set()
    while stack:
        node = stack.pop()
        if node is None or node in stop or node in seen:
            continue
        seen.add(node)
        prev: list = []
        node.register_prehook(functools.partial(_enter_region, split, prev))
        node.register_hook(functools.partial(_leave_region, prev))
        stack.extend(n for n, _ in node.next_functions)


def _enter_region(split: int, prev: list, grads) -> None:
    prev.append(_REGION_RANKS.get())
    _REGION_RANKS.set(split)


def _leave_region(prev: list, grads_in, grads_out) -> None:
    _REGION_RANKS.set(prev.pop())


def axis_rank(mesh, dim: str) -> int:
    """This rank's coordinate on mesh dimension ``dim`` (0 if the mesh has
    no such dimension)."""
    if dim not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(dim)


def local_region(fn, args: tuple, in_placements: tuple, out_placements, *, in_grad_placements=None):
    """``fn(*args)`` on each rank's local shards: the counterpart of the
    reference's ``shard_map``. A DTensor argument is first redistributed to
    its entry of ``in_placements`` (None for an argument that is not a
    tensor); the outputs become DTensors with ``out_placements`` (one
    placement tuple, or a tuple of them for a tuple of outputs). A
    parameter whose gradient is a partial sum over the ranks that split
    the tokens gives that in ``in_grad_placements``. Without a DTensor
    argument ``fn`` runs as it is."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)

    from torch.distributed.tensor import Placement, Shard

    single = isinstance(out_placements[0], Placement)

    split = 1
    for i in range(mesh.ndim):
        if any(pl is not None and isinstance(pl[i], Shard) for pl in in_placements):
            split *= mesh.size(i)

    def counted(*local_args):
        tok = _REGION_RANKS.set(split)
        try:
            out = fn(*local_args)
        finally:
            _REGION_RANKS.reset(tok)
        out = (out,) if single else out
        if _COUNTING.get() and split > 1 and torch.is_grad_enabled():
            _mark_backward(out, local_args, split)
        return out

    out = local_map(counted, out_placements=(tuple(out_placements),) if single else tuple(out_placements),
                    in_placements=in_placements, in_grad_placements=in_grad_placements, device_mesh=mesh,
                    redistribute_inputs=True)(*args)
    return out[0] if single else out


def logical_region(fn, args: tuple, in_logical: tuple, out_like, *, params: tuple = ()):
    """:func:`local_region` with the placements of logical axes on the
    current mesh: ``in_logical`` holds one logical tuple an argument (None
    for one that is not a tensor); ``out_like`` one ``(logical, shape)``
    pair, or a list of them for a tuple of outputs (the global shapes).
    Arguments at the indices ``params`` are parameters: each rank's
    gradient of one is a partial sum over every mesh dimension that splits
    the other inputs and not the parameter. Without a DTensor argument
    ``fn`` runs as it is."""
    from torch.distributed.tensor import Partial, Shard

    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    in_pl = tuple(None if lg is None else placements_for(mesh, lg, tuple(a.shape)) for a, lg in zip(args, in_logical))
    split = {i for j, pl in enumerate(in_pl) if pl is not None and j not in params
             for i, p in enumerate(pl) if isinstance(p, Shard)}
    grad_pl = tuple(
        None if pl is None else (tuple(p if isinstance(p, Shard) else (Partial() if i in split else p)
                                       for i, p in enumerate(pl)) if j in params else pl)
        for j, pl in enumerate(in_pl))
    if isinstance(out_like, list):
        out_pl = tuple(placements_for(mesh, lg, tuple(shape)) for lg, shape in out_like)
    else:
        out_pl = placements_for(mesh, out_like[0], tuple(out_like[1]))
    return local_region(fn, args, in_pl, out_pl, in_grad_placements=grad_pl)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` of two operands; on DTensors, each rank's
    product of its local shards (the tensor parallelism of the reference's
    sharded ``einsum``). On each mesh dimension: where both operands shard
    one label, the product is sharded on it (a partial sum when it is
    contracted); where one operand shards a label the other has, the other
    takes the same shard; where they shard different labels, ``b`` (the
    weight) is gathered on that dimension (FSDP). A label sharded in one
    operand alone shards the output. The gradient of an operand that is
    replicated on a dimension where the other splits the work is a partial
    sum there."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (a if is_dtensor(a) else b).device_mesh
    rep = (Replicate(),) * mesh.ndim
    a, b = (x if is_dtensor(x) else keep_shard(x, mesh, rep) for x in (a, b))
    lhs, out = eq.replace(" ", "").split("->")
    la, lb = lhs.split(",")

    def label(x, lab, m):
        pl = x.placements[m]
        return lab[pl.dim % x.dim()] if isinstance(pl, Shard) else None

    def unpartial(x):
        if any(isinstance(p, Partial) for p in x.placements):
            return x.redistribute(mesh, tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements))
        return x

    a, b = unpartial(a), unpartial(b)
    pa, pb, po, ga, gb = [], [], [], [], []
    for m in range(mesh.ndim):
        sa, sb = label(a, la, m), label(b, lb, m)
        if sa is not None and sb is not None and sa != sb:
            sb = None  # gather the weight on this dimension
        lab = sa if sa is not None else sb
        if lab is None:
            pa.append(Replicate()), pb.append(Replicate()), po.append(Replicate())
            ga.append(Replicate()), gb.append(Replicate())
            continue
        in_a, in_b = lab in la, lab in lb
        pa.append(Shard(la.index(lab)) if in_a else Replicate())
        pb.append(Shard(lb.index(lab)) if in_b else Replicate())
        po.append(Shard(out.index(lab)) if lab in out else Partial())
        ga.append(pa[-1] if in_a else Partial())
        gb.append(pb[-1] if in_b else Partial())
    return local_region(lambda x, y: torch.einsum(eq, x, y), (a, b), (tuple(pa), tuple(pb)), tuple(po),
                        in_grad_placements=(tuple(ga), tuple(gb)))


def pointwise(fn, x):
    """``fn(x)`` of an elementwise ``fn``; on a DTensor, on each rank's
    shard (for an operation DTensor has no rule for, such as
    ``logsigmoid``): a partial sum is summed first."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate

    pl = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
    return local_region(fn, (x,), (pl,), pl)


def shard_bounds(shape: tuple, mesh, placements) -> tuple[tuple, tuple]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` with ``placements`` on ``mesh``."""
    from torch.distributed.tensor import Shard

    local, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, n = pl.dim % len(shape), mesh.size(i)
            # torch.chunk's split, as DTensor's: pieces of ceil(L / n)
            step = -(-local[d] // n)
            start = min(coord[i] * step, local[d])
            off[d] += start
            local[d] = min(step, local[d] - start)
    return tuple(local), tuple(off)


def from_shard(piece: torch.Tensor, mesh, placements, shape: tuple):
    """The DTensor of the contiguous global ``shape`` whose shard on this
    rank is ``piece`` (each rank gives its own; no collective)."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(piece, mesh, tuple(placements), run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def keep_shard(whole: torch.Tensor, mesh, placements):
    """The DTensor whose value is ``whole`` (the same on every rank), each
    rank keeping a copy of its own shard; no collective."""
    local, off = shard_bounds(whole.shape, mesh, placements)
    if tuple(local) == tuple(whole.shape):
        piece = whole.contiguous()
    else:  # a copy: a view would keep the whole tensor's storage alive
        piece = whole[tuple(slice(o, o + n) for o, n in zip(off, local))].clone(memory_format=torch.contiguous_format)
    return from_shard(piece, mesh, placements, whole.shape)


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


# -- the host-staged backend -------------------------------------------------

STAGED_BACKEND = "staged"


@functools.cache
def _staged_group_class():
    """The staged process group's class (made on first use: it subclasses
    the C++ ``ProcessGroup``)."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import _create_work_from_future
    from torch.futures import Future

    def done(result=None):
        fut = Future()
        fut.set_result(result)
        return _create_work_from_future(fut)

    class StagedGroup(dist.ProcessGroup):
        """Each collective on host copies of CUDA tensors, through a gloo
        group of the same ranks; results copied back in place."""

        def __init__(self, gloo, rank: int, size: int):
            super().__init__(rank, size)
            self._gloo, self._size = gloo, size

        def size(self):
            return self._size

        def getBackendName(self):
            return STAGED_BACKEND

        @property
        def group_name(self):
            # a Python process group holds no backend that would keep it
            return dist.distributed_c10d._world.pg_names[self]

        @property
        def pg_name(self):
            return self.group_name

        def _run(self, outs: list, ins: list, fn):
            """``fn(host outs, host ins)`` runs the gloo collective; CUDA
            tensors are staged, the outputs copied back. A group of one rank
            (a mesh dimension of size 1) copies each input to its output,
            on the device."""
            if self._size == 1:
                for o, i in zip(outs, ins):
                    if o is not i:
                        o.copy_(i)
                return done(outs)
            t0 = time.perf_counter()
            h_in = [t.cpu() if t.is_cuda else t for t in ins]
            h_out = [torch.empty(t.shape, dtype=t.dtype) if t.is_cuda else t for t in outs]
            fn(h_out, h_in)
            for t, h in zip(outs, h_out):
                if t is not h:
                    t.copy_(h)
            collectives["staged_calls"] += 1
            collectives["staged_bytes"] += sum(t.numel() * t.element_size() for t in ins)
            collectives["staged_ms"] += (time.perf_counter() - t0) * 1e3
            return done(outs)

        def _in_place(self, tensors, op):
            """A collective that works in place (all-reduce, broadcast):
            the host copies carry the inputs in."""

            def fn(o, i):
                for a, b in zip(o, i):
                    if a is not b:
                        a.copy_(b)
                op(o).wait()

            return self._run(tensors, tensors, fn)

        def allreduce(self, tensors, opts=None):
            from torch.distributed import AllreduceOptions

            opts = opts or AllreduceOptions()
            return self._in_place(tensors, lambda o: self._gloo.allreduce(o, opts))

        def allreduce_coalesced(self, tensors, opts=None):
            return self.allreduce(tensors, opts)

        def _allgather_base(self, output, input, opts=None):
            def fn(o, i):
                parts = list(torch.chunk(o[0], self._size))
                self._gloo.allgather([parts], [i[0]]).wait()
            return self._run([output], [input], fn)

        all_gather_single = _allgather_base

        def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
            for o, i in zip(outputs, inputs):
                self._allgather_base(o, i, opts)
            return done(outputs)

        all_gather_single_coalesced = allgather_into_tensor_coalesced

        def allgather(self, output_lists, inputs, opts=None):
            flat = [t for lst in output_lists for t in lst]

            def fn(o, i):
                it = iter(o)
                self._gloo.allgather([[next(it) for _ in lst] for lst in output_lists], i).wait()
            return self._run(flat, inputs, fn)

        def _reduce_scatter_base(self, output, input, opts=None):
            from torch.distributed import AllreduceOptions

            def fn(o, i):
                whole = i[0].clone()
                ar = AllreduceOptions()
                if opts is not None:
                    ar.reduceOp = opts.reduceOp
                self._gloo.allreduce([whole], ar).wait()
                o[0].copy_(torch.chunk(whole, self._size)[self.rank()])
            return self._run([output], [input], fn)

        reduce_scatter_single = _reduce_scatter_base

        def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
            for o, i in zip(outputs, inputs):
                self._reduce_scatter_base(o, i, opts)
            return done(outputs)

        reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

        def alltoall_base(self, output, input, output_split_sizes, input_split_sizes, opts=None):
            def fn(o, i):
                self._gloo.alltoall_base(o[0], i[0], output_split_sizes, input_split_sizes).wait()
            return self._run([output], [input], fn)

        def all_to_all_single(self, output, input, output_split_sizes, input_split_sizes, opts=None):
            return self.alltoall_base(output, input, output_split_sizes or [], input_split_sizes or [], opts)

        def broadcast(self, tensors, opts=None):
            from torch.distributed import BroadcastOptions

            opts = opts or BroadcastOptions()
            return self._in_place(tensors, lambda o: self._gloo.broadcast(o, opts))

        def barrier(self, opts=None):
            self._gloo.allreduce([torch.zeros(1)]).wait()
            return done()

    return StagedGroup


def _create_staged(store, rank: int, size: int, timeout):
    import torch.distributed as dist

    gloo = dist.ProcessGroupGloo(dist.PrefixStore("staged-gloo", store), rank, size, timeout)
    return _staged_group_class()(gloo, rank, size)


def _register_staged() -> None:
    import torch.distributed as dist

    if dist.is_available() and STAGED_BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(STAGED_BACKEND, _create_staged, devices=["cpu", "cuda"])


_register_staged()
