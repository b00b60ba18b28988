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
  the (hi, lo) words of each element's flat index
* ``uniform(k, shape)`` == f32 ``uniform``: ``((bits >> 9) | 0x3F800000)``
  viewed as f32, minus 1
* ``randint``          == ``jax/_src/random.py: _randint`` for int32

``normal`` and ``choice`` are not ported yet.
"""

from __future__ import annotations

import math

import torch

__all__ = ["key", "fold_in", "split", "bits", "uniform", "randint", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
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


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words (values in ``[0, 2**32)`` held in int64).

    Keys ``(..., 2)`` give ``(...,) + shape``: each key draws its own
    ``shape``-sized block, counted from flat index 0.
    """
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    batch = k.shape[:-1]
    k0 = k[..., 0].reshape(batch + (1,))
    k1 = k[..., 1].reshape(batch + (1,))
    x0, x1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (x0 ^ x1).reshape(batch + shape)


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """f32 uniforms in ``[0, 1)``, bit-exact with ``jax.random.uniform``."""
    mant = (bits(k, shape) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


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
