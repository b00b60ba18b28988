"""Threefry-2x32 counter-based PRNG, bit-compatible with ``jax.random``.

The JAX package pins ``jax_threefry_partitionable``, under which every draw
is a pure function of ``(key, element index)``. This module reproduces that
stream exactly, so the port draws the same client batches and the same
quantizer uniforms as the reference and its packed wire can be held to the
JAX wire bit for bit. torch's own generators (Philox) cannot do that.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
leading dimensions batch independent keys. torch has no full uint32
arithmetic, so every add and rotation runs in int64 and is masked back to
32 bits.

Mapping to ``jax.random`` (jax 0.9, partitionable threefry):

* ``key(seed)``        == ``PRNGKey(seed)`` = ``[seed >> 32, seed & 0xFFFFFFFF]``
* ``fold_in(k, d)``    == threefry(k, (0, d))
* ``split(k, n)[i]``   == ``fold_in(k, i)``
* ``bits(k, shape)``   == 32-bit ``random_bits``: ``x0 ^ x1`` of threefry over
  the (hi, lo) words of each element's flat index; a 16-bit draw is its low
  16 bits (``convert_element_type`` of the same word)
* ``uniform(k, shape)`` == f32 ``uniform``: ``((bits >> 9) | 0x3F800000)``
  viewed as f32, minus 1; with ``minval``, scaled and shifted as
  ``max(minval, u * (1 - minval) + minval)``
* ``gumbel(k, shape)`` == f32 ``gumbel`` (its default "low" mode):
  ``-log(-log(u))``, ``u`` uniform on ``[tiny, 1)``, with XLA's CPU log
* ``categorical(k, logits)`` == ``categorical`` over the last axis:
  ``argmax(gumbel + logits)``
* ``randint``          == ``jax/_src/random.py: _randint`` for int32
* ``normal(k, shape)``  == f32 ``normal``: ``sqrt(2) * erf_inv(u)`` with
  ``u`` uniform on ``[nextafter(-1, 0), 1)`` and ``erf_inv`` the f32
  expansion that XLA's CPU backend compiles, FMA contractions included
* ``permutation(k, n)`` == ``permutation`` of ``arange(n)``: rounds of a
  stable sort keyed by fresh 32-bit words
* ``choice(k, n, (m,))`` == ``choice(k, n, (m,), replace=False)`` without ``p``
"""

from __future__ import annotations

import math
import struct

import torch

__all__ = [
    "key", "fold_in", "split", "bits", "uniform", "randint", "normal", "gumbel", "categorical", "permutation",
    "choice",
    "threefry2x32", "shard_flat_index", "shard_flat_at",
]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 words.

    The two words are updated in place in fresh buffers of the broadcast
    shape: on the CPU a new allocation a step costs more than the step.
    """
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    x0 = (x0 + k0).broadcast_to(shape).contiguous().bitwise_and_(_MASK)
    x1 = (x1 + k1).broadcast_to(shape).contiguous().bitwise_and_(_MASK)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            torch.bitwise_left_shift(x1, r, out=t)  # rotl(x1, r) ^ x0
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_and_(_MASK).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` int64 tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` (int or int tensor) broadcasts
    against the key's batch dims: keys ``(..., 2)`` and data ``D`` give
    ``broadcast(..., D) + (2,)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``(..., 2)`` -> ``(..., n, 2)``."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    return fold_in(k.unsqueeze(-2), idx)


def bits(k: torch.Tensor, shape, offset: int = 0, index: torch.Tensor | None = None) -> torch.Tensor:
    """32-bit random words (values in ``[0, 2**32)`` held in int64).

    Keys ``(..., 2)`` give ``(...,) + shape``: each key draws its own
    ``shape``-sized block, counted from flat index ``offset`` (0: the whole
    draw; a later offset continues the same stream, so a long draw can be
    made a block at a time with the same bits). ``index`` (int64, of
    ``shape``'s size) gives the flat indices of the draw to take instead:
    the words a shard of a larger draw holds.
    """
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=k.device) if index is None else index.reshape(n)
    batch = k.shape[:-1]
    k0 = k[..., 0].reshape(batch + (1,))
    k1 = k[..., 1].reshape(batch + (1,))
    x0, x1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (x0 ^ x1).reshape(batch + shape)


def shard_flat_index(shape: tuple, local: tuple, offset: tuple, lo: int, hi: int, device) -> torch.Tensor:
    """The flat indices, in the whole ``shape``'s row-major order, of the
    shard's coordinates ``lo .. hi`` in its own row-major order (the shard
    ``local`` starts at ``offset``): int64 on ``device``."""
    lin = torch.arange(lo, hi, dtype=torch.int64, device=device)
    g = torch.zeros_like(lin)
    stride = 1
    for k in reversed(range(len(shape))):
        g += (lin % local[k] + offset[k]) * stride
        lin = lin // local[k]
        stride *= shape[k]
    return g


def shard_flat_at(shape: tuple, local: tuple, offset: tuple, i: int) -> int:
    """The whole ``shape``'s flat index of the shard's ``i``-th coordinate
    (Python ints; it grows with ``i``)."""
    g, stride = 0, 1
    for k in reversed(range(len(shape))):
        g += (i % local[k] + offset[k]) * stride
        i //= local[k]
        stride *= shape[k]
    return g


def uniform(k: torch.Tensor, shape, offset: int = 0, minval: float = 0.0,
            index: torch.Tensor | None = None) -> torch.Tensor:
    """f32 uniforms in ``[minval, 1)``, bit-exact with
    ``jax.random.uniform`` (``offset`` and ``index`` as in :func:`bits`). With a
    ``minval`` the draw is ``max(minval, u * (1 - minval) + minval)`` in f32
    with the multiply-add fused, as XLA compiles ``jax.random.uniform``
    (always jitted)."""
    mant = (bits(k, shape, offset, index) >> 9) | 0x3F800000
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0:
        return u
    lo = _r32(minval)
    span = float(torch.tensor(1.0) - torch.tensor(lo, dtype=torch.float32))
    return torch.clamp_min(_fma(span, u, lo), lo)


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint`` (two draws from a split key, combined
    by multiply-mod in uint32 arithmetic); returned as int64 indices."""
    span = maxval - minval if maxval > minval else 1
    if not 0 < span <= _MASK:
        raise ValueError(f"randint span must fit in uint32, got {span}")
    ks = split(k, 2)
    higher, lower = bits(ks[..., 0, :], shape), bits(ks[..., 1, :], shape)
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + (lower % span)
    offset = (offset & _MASK) % span
    return minval + offset


# normal: XLA's f32 erf_inv (chlo.erf_inv as XLA expands it) over log1p and
# log as XLA's CPU backend emits them, with every multiply-add that LLVM
# contracts there computed as one fused multiply-add. The f32 basic
# operations (+, -, *) round the same on the CPU and the card; division,
# square root and the fused multiply-adds run in f64 and round once to f32,
# so no transcendental function of either platform's library is called.

_LO = -(1.0 - 2.0**-24)  # nextafter(-1, 0) in f32
_SQRT2 = 1.4142135381698608  # f32(sqrt(2))
_SQRT2_M1 = 0.41421356237309504880  # log1p switches to log(1 + x) at this |x|
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972e-1, 6.5787325942061044846e0,
              2.9911919328553073277e1, 6.0949667980987787057e1, 5.7112963590585538103e1,
              2.0039553499201281259e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469e1, 2.2176239823732856465e2,
              3.0909872225312059774e2, 2.1642788614495947685e2, 6.0118660497603843919e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375  # Q2 is exact in f32
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                  -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                  -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _r32(c: float) -> float:
    """``c`` rounded to the nearest f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", c))[0]


def _fma(a, b: torch.Tensor, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, like a fused multiply-add (``a`` and
    ``c`` may be f32-exact Python floats).

    The product of two f32 values is exact in f64. The f64 sum is rounded
    to odd (its error, from an exact two-sum, moves an even result one ulp
    toward the exact value), which makes the final rounding to f32 the
    correct one.
    """
    p = b.double() * (a.double() if torch.is_tensor(a) else a)
    c = c.double() if torch.is_tensor(c) else torch.full_like(p, c)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(inexact_even, torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), err)), s)
    return s.float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """f32 log of positive normal ``x`` (Cephes's polynomial, XLA's CPU
    code): ``x = m * 2**e`` with ``m`` in ``[sqrt(1/2), sqrt(2))``."""
    bits_ = x.view(torch.int32)
    e = ((bits_ >> 23) - 0x7F).float() + 1.0
    m = ((bits_ & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < _r32(0.707106781186547524)
    m = torch.where(low, (m - 1.0) + m, m - 1.0)
    e = torch.where(low, e - 1.0, e)
    x2 = m * m
    x3 = x2 * m
    p = [_r32(c) for c in _LOG_P]
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _r32(_LOG_Q1))
    m = _fma(-0.5, x2, m) + y
    return _fma(_LOG_Q2, e, m)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _r32(c))
    return p


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 log1p of ``x`` in ``(-1, 0]``: Cephes's rational form below
    ``sqrt(2) - 1`` in magnitude, else ``log(1 + x)``."""
    x2 = x * x
    r = (_horner(x, _LOG1P_NUM).double() / _horner(x, _LOG1P_DEN).double()).float()
    small = x + _fma(-0.5, x2, (x * x2) * r)
    large = _log(torch.clamp(x + 1.0, min=torch.finfo(torch.float32).tiny))
    return torch.where(x.abs() < _r32(_SQRT2_M1), small, large)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 erf_inv of ``x`` in ``(-1, 1)`` (Giles's single-precision
    polynomial in ``w = -log1p(-x**2)``)."""
    w = -_log1p(-(x * x))
    lt5 = w < 5.0
    w = torch.where(lt5, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.zeros_like(x)
    for c_lt, c_ge in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        p = _fma(p, w, torch.where(lt5, _r32(c_lt), _r32(c_ge)))
    return p * x


def normal(k: torch.Tensor, shape, scale: float = 1.0, offset: int = 0,
           index: torch.Tensor | None = None) -> torch.Tensor:
    """f32 ``scale * N(0, 1)`` draws, bit-exact with ``jax.random.normal``
    on the CPU: ``erf_inv(u) * f32(sqrt(2) * scale)``, ``u`` uniform on
    ``[nextafter(-1, 0), 1)`` (``2 * uniform + lo`` is exact). Under ``jit``
    XLA folds a constant ``scale`` into the ``sqrt(2)`` factor, and so does
    this. Batched keys, ``offset`` and ``index`` as in :func:`uniform`."""
    u = torch.clamp(uniform(k, shape, offset, index=index) * 2.0 + _LO, min=_LO)
    return _erf_inv(u) * _r32(_SQRT2 * _r32(scale))


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """f32 standard Gumbel draws, bit-exact with ``jax.random.gumbel``
    (``mode="low"``, its default): ``-log(-log(u))`` with ``u`` uniform on
    ``[tiny, 1)`` and both logs XLA's CPU log (:func:`_log`), so the draws
    are the same on the card."""
    u = uniform(k, shape, minval=torch.finfo(torch.float32).tiny)
    return -_log(-_log(u))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` over the last axis of f32
    ``logits``: ``argmax(gumbel + logits)``, ties to the first index as
    ``jnp.argmax`` breaks them."""
    return torch.argmax(gumbel(k, logits.shape) + logits, dim=-1)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    rounds, each ``k, sub = split(k)`` and a stable sort of the values by
    ``bits(sub, (n,))``. Returns int64 indices."""
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    for _ in range(rounds):
        k, sub = split(k, 2)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(k: torch.Tensor, n: int, shape) -> torch.Tensor:
    """``jax.random.choice(k, n, shape, replace=False)`` (uniform, no
    ``p``): the first ``prod(shape)`` entries of :func:`permutation`."""
    shape = tuple(shape)
    m = math.prod(shape)
    if m > n:
        raise ValueError(f"Cannot take a larger sample (size {m}) than population (size {n}) when 'replace=False'")
    return permutation(k, n)[:m].reshape(shape)
