"""Threefry-2x32 and the draws built on it, frozen for the benchmark.

A copy of the counter-based generator that the PRoBit+ wire draws its
quantizer uniforms, client batches and round keys from (``jax.random``'s
partitionable Threefry, bit for bit): a later change to the program's own
generator cannot move the reference. Words are uint32 values held in
int64 tensors; every add and rotation is masked back to 32 bits.

* ``key(seed)``          ``[seed >> 32, seed & 0xFFFFFFFF]``
* ``fold_in(k, d)``      ``threefry(k, (0, d))``
* ``split(k, n)[i]``     ``fold_in(k, i)``
* ``bits(k, n)``         ``x0 ^ x1`` of Threefry over each flat index's (hi, lo) words
* ``uniform(k, n)``      ``((bits >> 9) | 0x3F800000)`` as f32, minus 1
* ``randint``            two draws of a split key combined by multiply-mod
* ``chunk_uniforms``     a quantizer row: chunk ``j`` of 8,192 coordinates
  draws ``uniform(fold_in(client_key, j), 8192)``

Imports nothing but torch.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK = 8192  # coordinates a quantizer chunk draws from one key
BLOCK_WORDS = 1 << 27  # words drawn at a time: 1 GiB an int64 temporary


def threefry2x32(k0, k1, x0, x1):
    """Twenty rounds of Threefry-2x32 on broadcastable int64 words, updated
    in place in buffers of the broadcast shape."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    x0 = (x0 + k0).broadcast_to(shape).contiguous().bitwise_and_(MASK)
    x1 = (x1 + k1).broadcast_to(shape).contiguous().bitwise_and_(MASK)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_left_shift(x1, r, out=t)  # x1 = rotl(x1, r) ^ x0
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_and_(MASK).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """Keys ``(..., 2)`` and int data ``D`` give ``broadcast(..., D) + (2,)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(k: torch.Tensor, n: int) -> torch.Tensor:
    return fold_in(k.unsqueeze(-2), torch.arange(n, dtype=torch.int64, device=k.device))


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit words of each key: keys ``(..., 2)`` give ``(..., n)``."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k[..., 0:1], k[..., 1:2], idx >> 32, idx & MASK)
    return x0 ^ x1


def uniform(k: torch.Tensor, n: int) -> torch.Tensor:
    mant = (bits(k, n) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def randint(k: torch.Tensor, n: int, span: int) -> torch.Tensor:
    """``n`` int32 draws in ``[0, span)`` of each key (``jax.random.randint``'s
    rule), as int64."""
    ks = split(k, 2)
    higher, lower = bits(ks[..., 0, :], n), bits(ks[..., 1, :], n)
    mult = (2**16) % span
    mult = ((mult * mult) & MASK) % span
    off = (((higher % span) * mult) & MASK) + (lower % span)
    return (off & MASK) % span


def chunk_uniforms(client_key: torch.Tensor, n: int) -> torch.Tensor:
    """The (n,) quantizer uniforms of one client's row of ``n`` coordinates,
    drawn in blocks of whole chunks of at most :data:`BLOCK_WORDS` words."""
    chunks = -(-n // CHUNK)
    per_block = max(1, BLOCK_WORDS // CHUNK)
    out = torch.empty(chunks * CHUNK, dtype=torch.float32, device=client_key.device)
    for j0 in range(0, chunks, per_block):
        j = torch.arange(j0, min(j0 + per_block, chunks), dtype=torch.int64, device=client_key.device)
        out[j0 * CHUNK:(j0 + j.numel()) * CHUNK] = uniform(fold_in(client_key, j), CHUNK).reshape(-1)
    return out[:n]
