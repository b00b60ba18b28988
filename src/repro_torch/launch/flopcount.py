"""FLOP and logical-byte counting of a traced step.

Counterpart of ``repro/launch/flopcount.py``. The reference walks a jaxpr
and multiplies scan bodies by their trip counts; the port runs the step's
Python loops as they are, under a ``TorchDispatchMode`` that sees every
aten operation once, so a loop is counted as it runs and
``unknown_while_loops`` is always 0.

Matrix products and convolutions take their FLOPs from
``torch.utils.flop_counter``'s formulas (``2 * M * N * K`` a product) and
are also reported alone as ``dot_flops``; the other operations fall into
an elementwise group (one FLOP an output element, ``elementwise_flops``)
and a data-movement group (``movement_bytes``) that mirror the
reference's ``_ELEMENTWISE`` and ``_DATA_MOVEMENT`` sets, aten's names for
the same operations. Every operation counts its bytes (inputs and
outputs) in ``bytes_total``, an unknown one too, as the reference does an
unknown primitive.

On DTensors the mode sees each operation with the global shapes: one
count a logical operation, however it is sharded. Inside a
:func:`repro_torch.distributed.local_region` the operations run on local
shards and count times the number of ranks that split the region's work
(:func:`repro_torch.distributed.region_ranks`), so a region counts its
global work once; so does the backward of those operations, whose
autograd nodes the regions mark while a counter is on
(:func:`repro_torch.distributed.counting_regions`).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import distributed

__all__ = ["ELEMENTWISE", "DATA_MOVEMENT", "FlopCounter", "count_fn"]

_A = torch.ops.aten

# aten's names for the reference's elementwise primitives
ELEMENTWISE = {
    _A.add, _A.sub, _A.rsub, _A.mul, _A.div, _A.maximum, _A.minimum, _A.pow, _A.remainder, _A.fmod,
    _A.exp, _A.log, _A.log1p, _A.tanh, _A.sigmoid, _A.rsqrt, _A.sqrt, _A.erf, _A.neg, _A.abs, _A.sign,
    _A.floor, _A.ceil, _A.round, _A.cos, _A.sin, _A.where, _A.clamp, _A.clamp_min, _A.clamp_max,
    _A.cumsum, _A.cummax, _A.cumprod, _A.logcumsumexp, _A.bitwise_and, _A.bitwise_or, _A.bitwise_not,
    _A.bitwise_xor, _A.logical_and, _A.logical_or, _A.logical_not, _A.logical_xor, _A.eq, _A.ne, _A.lt,
    _A.le, _A.gt, _A.ge, _A.nextafter, _A.squeeze, _A.unsqueeze, _A.reciprocal, _A.addcmul, _A.silu,
    _A.gelu, _A.log_sigmoid_forward, _A.square, _A.exp2, _A.masked_fill, _A.fill,
}

# aten's names for the reference's data-movement primitives
DATA_MOVEMENT = {
    _A._to_copy, _A.view, _A._unsafe_view, _A.reshape, _A.transpose, _A.t, _A.permute, _A.expand,
    _A.cat, _A.stack, _A.slice, _A.select, _A.narrow, _A.index_select, _A.copy_, _A.slice_scatter,
    _A.select_scatter, _A.index, _A.gather, _A.take_along_dim, _A.scatter, _A.scatter_add, _A.index_put,
    _A.index_add, _A.constant_pad_nd, _A.flip, _A.arange, _A.sum, _A.amax, _A.amin, _A.max, _A.min,
    _A.prod, _A.argmax, _A.argmin, _A.sort, _A.topk, _A.clone, _A.split, _A.split_with_sizes,
    _A.unbind, _A.roll, _A.embedding, _A.mean, _A.any, _A.all, _A.logsumexp, _A._softmax,
    _A._log_softmax, _A.zeros_like, _A.ones_like, _A.full_like, _A.empty_like, _A.new_zeros,
    _A.new_empty, _A.new_full, _A.zeros, _A.ones, _A.full, _A.empty, _A.alias, _A.detach,
}


def _tensors(x) -> list:
    """The tensors among an operation's arguments or outputs (one level of
    lists and tuples, as aten's schemas have)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        out = []
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(t for t in v if isinstance(t, torch.Tensor))
        return out
    if isinstance(x, dict):
        return _tensors(list(x.values()))
    return []


def _bytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


_SKIP = (torch.ops.prim.device.default,)  # metadata queries: no work, no output tensor


class FlopCounter(TorchDispatchMode):
    """Counts ``flops`` (dots and elementwise), ``dot_flops`` and the
    logical ``bytes`` (inputs plus outputs) of every operation it sees,
    and hands each output to ``live`` (an ``analysis.LiveBytes``) when
    given. It sees a DTensor operation before DTensor runs it (its global
    shapes, its local output), and none of the operations DTensor runs
    inside it."""

    def __init__(self, live=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._live = live
        self._formulas = flop_registry
        self.flops = 0.0
        self.dot_flops = 0.0
        self.elementwise_flops = 0.0
        self.bytes = 0.0
        self.movement_bytes = 0.0

    def __enter__(self):
        self._marking = distributed.counting_regions()
        self._marking.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marking.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _SKIP or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        mult = float(distributed.region_ranks())
        outs = _tensors(out)
        moved = mult * (_bytes(_tensors(args)) + _bytes(_tensors(kwargs)) + _bytes(outs))
        self.bytes += moved
        if packet in self._formulas:
            f = mult * self._formulas[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.dot_flops += f
        elif packet in ELEMENTWISE:
            f = mult * sum(t.numel() for t in outs)
            self.flops += f
            self.elementwise_flops += f
        elif packet in DATA_MOVEMENT:
            self.movement_bytes += moved
        if self._live is not None:
            self._live.track(outs)
        return out


def count_fn(fn, *args) -> dict:
    """Run ``fn(*args)`` under a :class:`FlopCounter` (inside whatever modes
    the caller set, e.g. ``FakeTensorMode``): global FLOP and byte totals
    in the reference's keys, plus ``dot_flops``."""
    c = FlopCounter()
    with c:
        fn(*args)
    return {
        "flops_total": c.flops,
        "bytes_total": c.bytes,
        "dot_flops": c.dot_flops,
        "elementwise_flops": c.elementwise_flops,
        "movement_bytes": c.movement_bytes,
        "unknown_while_loops": 0,
    }
