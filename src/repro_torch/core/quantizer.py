"""Stochastic one-bit compressor (paper Eq. 5) and the packed wire format.

Counterpart of ``repro/core/quantizer.py`` for the one-bit wire. A client
with model difference ``delta`` and public range ``b`` emits

    c_i = +1  with probability (b_i + delta_i) / (2 b_i)
    c_i = -1  otherwise

packed 8 codes to a byte, LSB first (bit 1 encodes +1). The uniforms come
from the port's Threefry (:mod:`repro_torch.prng`) on the reference's
counter-derived schedule, so the wire is byte-identical to the JAX wire.

Wire widths: the chunked packer here emits ``padded_dim(d)/8`` bytes a row;
the kernel wire of :mod:`repro_torch.kernels.ops` emits
``padded_len(d)/8``. Pad coordinates carry delta = -1, b = 1, so their bits
are deterministically 0 and the two widths realign losslessly.

Vote counts come two ways: :func:`packed_counts` (int32, exact) and
:func:`packed_weighted_counts` (f32, each client's bits times its weight),
which the buffered-asynchronous server and the streaming round's padded
chunks use.

The k-bit wire (``bits`` in :data:`WIRE_BITS`) rounds a clipped delta
stochastically onto the ``L = 2**k``-level grid ``v_l = -b + l * 2b/(L-1)``
(:func:`quantize_levels`; Eq. 5 is L = 2) and sends the level index as
``k`` one-bit planes, each packed like the one-bit wire, plane-major along
the byte axis (:func:`pack_levels`), so the vote counts of a k-bit row are
the per-plane counts. :func:`packed_quantize_batch` draws on the one-bit
wire's counter-derived schedule and, with ``gamma``, mixes in L-level
randomized response. The grid step ``2b/(L-1)`` is ``2b * f32(1/(L-1))``
and the grid value ``-b + l * step`` one fused multiply-add, as the
reference computes them under ``jit`` (XLA folds a division by a constant
into its reciprocal and contracts the multiply-add).

``rand_bits=16`` (the LM trainer's option, :func:`packed_binarize_batch`)
compares the low 16 bits of each Threefry word with ``floor(p * 65536)``
in a wider integer (:func:`threshold_u16`), so a certain vote stays
certain.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import prng

__all__ = [
    "PACK_CHUNK",
    "WIRE_BITS",
    "wire_bytes",
    "binarize_prob",
    "pack_bits",
    "unpack_bits",
    "stochastic_binarize",
    "codes_to_counts",
    "byte_popcount",
    "padded_dim",
    "client_uniforms",
    "client_bits16",
    "threshold_u16",
    "uniform_block_rows",
    "draw_blocks",
    "cohort_uniforms",
    "shard_uniforms",
    "pad_rows",
    "level_positions",
    "level_probs",
    "quantize_levels",
    "dequantize_levels",
    "pack_levels",
    "unpack_levels",
    "packed_binarize_batch",
    "packed_quantize_batch",
    "packed_sign_batch",
    "packed_counts",
    "packed_weighted_counts",
    "packed_residuals",
]

PACK_CHUNK = 8192  # coordinates per uniform-draw chunk (multiple of 8)

# Per-value wire widths: 8/k divides a byte and the levels fit uint8.
WIRE_BITS = (1, 2, 4)


def wire_bytes(d: int, bits: int = 1, *, topk_frac: float = 1.0, d_pad: int | None = None) -> int:
    """Uplink bytes of one client's packed wire row (``bits`` per value).

    ``d_pad`` is the padded coordinate count the producing wire emits
    (``padded_dim`` for the chunked packer, ``ops.padded_len`` for the
    kernel wire); ``None`` gives the unpadded ``ceil(d/8)`` floor.
    ``topk_frac < 1`` prices the sparse wire: int32 indices and packed
    codes of ``k = max(int(d * topk_frac), 1)`` coordinates.
    """
    if bits not in WIRE_BITS:
        raise ValueError(f"bits must be one of {WIRE_BITS}, got {bits}")
    if topk_frac < 1.0:
        k = max(int(d * topk_frac), 1)
        return 4 * k + bits * ((k + 7) // 8)
    n = d if d_pad is None else d_pad
    return bits * ((n + 7) // 8)


def binarize_prob(delta: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Probability that the compressor emits +1 (Eq. 5), with clipping.

    Same f32 operation order as the reference: clip, then
    ``0.5 + (0.5 * delta) / b``; a dead coordinate (``b <= 0``) gets 1/2.
    """
    delta = delta.float()
    b = torch.broadcast_to(b, delta.shape).float()
    delta = torch.clamp(delta, -b, b)
    live = b > 0
    safe_b = torch.where(live, b, torch.ones_like(b))
    p = 0.5 + 0.5 * delta / safe_b
    return torch.where(live, p, torch.full_like(p, 0.5))


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.int32, device=device)


def _pack_bool_lastdim(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8k) bool -> (..., k) uint8, LSB-first within each byte."""
    b8 = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8)).to(torch.int32)
    return (b8 << _shifts(bits.device)).sum(-1).to(torch.uint8)


def _unpack_lastdim(packed: torch.Tensor) -> torch.Tensor:
    """(..., k) uint8 -> (..., 8k) {0, 1} uint8, LSB-first."""
    x = packed.to(torch.int32).unsqueeze(-1) >> _shifts(packed.device)
    return (x & 1).to(torch.uint8).reshape(packed.shape[:-1] + (-1,))


def pack_bits(codes: torch.Tensor) -> torch.Tensor:
    """Pack ±1 codes into uint8 words, 8 codes a byte (LSB first); the
    flat length is padded to a multiple of 8 with -1 codes (0 bits)."""
    flat = codes.reshape(-1)
    pad = (-flat.shape[0]) % 8
    flat = torch.nn.functional.pad(flat, (0, pad), value=-1)
    return _pack_bool_lastdim(flat > 0)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns ±1 int8 codes of length ``n``."""
    bits = _unpack_lastdim(packed.reshape(-1))[:n]
    return bits.to(torch.int8) * 2 - 1


def stochastic_binarize(key: torch.Tensor, delta: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The one-bit codes ``c in {-1, +1}`` (int8) of Eq. 5: the reference's
    ``uniform(key, delta.shape) < binarize_prob(delta, b)``.

    Keys ``(..., 2)`` draw many clients in one pass, as ``jax.vmap`` of the
    reference over them: ``delta`` is ``key.shape[:-1] + shape`` (its
    leading sizes may be 1, to broadcast) and key ``k`` draws the uniforms
    of its own ``shape``-sized entry. The flat draw is not the packed
    wire's chunked schedule (:func:`client_uniforms`): the two give
    different bits by design. A long key batch is drawn in blocks along its
    leading axis, each block's Threefry temporaries near
    ``UNIFORM_BLOCK_WORDS`` words; a broadcast ``delta`` is never copied
    out to the batch's size.
    """
    batch = key.shape[:-1]
    shape = delta.shape[len(batch):]
    p = binarize_prob(delta, b)
    if not batch:
        return torch.where(prng.uniform(key, shape) < p, 1, -1).to(torch.int8)
    codes = torch.empty(batch + shape, dtype=torch.int8, device=delta.device)
    step = max(1, UNIFORM_BLOCK_WORDS // max(1, math.prod(batch[1:] + shape)))
    for r0 in range(0, batch[0], step):
        r1 = min(r0 + step, batch[0])
        p_blk = p if p.shape[0] == 1 else p[r0:r1]
        codes[r0:r1] = torch.where(prng.uniform(key[r0:r1], shape) < p_blk, 1, -1)
    return codes


def codes_to_counts(codes: torch.Tensor) -> torch.Tensor:
    """``N_i`` of Eq. 12: the number of +1 codes over the leading (client)
    axis, int32."""
    return (codes > 0).sum(0, dtype=torch.int32)


# bin(i).count("1") of every byte: torch has no population count
_POPCOUNT_LUT = tuple(bin(i).count("1") for i in range(256))


def byte_popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each byte (uint8 in, uint8 out), through the reference's
    256-entry uint8 table."""
    lut = torch.tensor(_POPCOUNT_LUT, dtype=torch.uint8, device=x.device)
    return lut[x.to(torch.uint8).long()]


def padded_dim(d: int, chunk: int = PACK_CHUNK) -> int:
    """Chunked-wire dimension: ``d`` rounded up to whole chunks."""
    return ((d + chunk - 1) // chunk) * chunk


def _chunk_keys(client_key: torch.Tensor, n: int, chunk: int, col0: int) -> torch.Tensor:
    """The ``(..., n_chunks, 2)`` keys ``fold_in(client_key, j)`` of the
    chunks ``j`` that cover columns ``col0 .. col0 + n`` (``col0`` a
    multiple of ``chunk``)."""
    j0 = col0 // chunk
    j = torch.arange(j0, j0 + padded_dim(n, chunk) // chunk, dtype=torch.int64, device=client_key.device)
    return prng.fold_in(client_key.unsqueeze(-2), j)


def client_uniforms(client_key: torch.Tensor, n: int, chunk: int = PACK_CHUNK, *, col0: int = 0) -> torch.Tensor:
    """The ``(n,)`` quantizer uniforms of a client, counter-derived per chunk.

    Chunk ``j`` draws ``uniform(fold_in(client_key, j), (chunk,))``, the
    schedule of the reference's ``client_uniforms`` and
    ``packed_binarize_batch``. Keys ``(..., 2)`` give ``(..., n)``, one row
    of uniforms per key. ``col0`` (a multiple of ``chunk``) gives columns
    ``col0 .. col0 + n`` of the row instead: a long row is drawn in blocks.
    """
    u = prng.uniform(_chunk_keys(client_key, n, chunk, col0), (chunk,))
    return u.reshape(client_key.shape[:-1] + (-1,))[..., :n]


def client_bits16(client_key: torch.Tensor, n: int, chunk: int = PACK_CHUNK, *, col0: int = 0) -> torch.Tensor:
    """The 16-bit draws of the ``rand_bits=16`` wire on the schedule of
    :func:`client_uniforms`, as int64: the reference's uint16 draw is the
    low 16 bits of the same 32-bit Threefry word."""
    w = prng.bits(_chunk_keys(client_key, n, chunk, col0), (chunk,)) & 0xFFFF
    return w.reshape(client_key.shape[:-1] + (-1,))[..., :n]


UNIFORM_BLOCK_WORDS = 1 << 27  # Threefry words per draw block: 1 GiB per int64 temporary


def uniform_block_rows(n: int) -> int:
    """Client rows per uniform-draw block for ``n`` coordinates a row, so
    that each int64 temporary of the Threefry stream stays near 1 GiB
    (100 rows at the MLP's width, 12 at ResNet-18's)."""
    return max(1, UNIFORM_BLOCK_WORDS // n)


def draw_blocks(rows: int, n_pad: int, chunk: int = PACK_CHUNK):
    """``(r0, r1, c0, c1)`` blocks of a ``(rows, n_pad)`` draw that keep each
    int64 temporary of the Threefry stream near ``UNIFORM_BLOCK_WORDS``:
    :func:`uniform_block_rows` whole rows at a time, and a row wider than
    the block (a transformer's stacked FFN leaf is one row of 385M) in
    chunk-aligned column ranges. Every draw is a pure function of (key,
    row, chunk), so the blocks change no bit."""
    if n_pad <= UNIFORM_BLOCK_WORDS:
        step = uniform_block_rows(n_pad)
        for r0 in range(0, rows, step):
            yield r0, min(r0 + step, rows), 0, n_pad
        return
    cols = max(chunk, UNIFORM_BLOCK_WORDS // chunk * chunk)
    for r in range(rows):
        for c0 in range(0, n_pad, cols):
            yield r, r + 1, c0, min(c0 + cols, n_pad)


def _row_keys(keys: torch.Tensor, m: int, rows: torch.Tensor, row_offset: int) -> torch.Tensor:
    """The client keys of flat group rows ``rows``: row ``r`` is client
    ``row_offset + r % m`` of element ``r // m``, keyed by ``keys[r // m]``."""
    return prng.fold_in(keys[rows // m], row_offset + rows % m)


def cohort_uniforms(
    key: torch.Tensor,
    m: int,
    n: int,
    chunk: int = PACK_CHUNK,
    *,
    row_offset: int = 0,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The ``(m, n)`` uniforms of clients ``row_offset .. row_offset + m - 1``:
    row ``i`` is :func:`client_uniforms` of ``fold_in(key, row_offset + i)``.
    Keys ``(E, 2)`` give the ``(E * m, n)`` uniforms of a group of E such
    cohorts, element ``e``'s rows keyed by ``key[e]``.

    Drawn a block of :func:`draw_blocks` at a time into ``out[:, :n]``,
    which may be wider (its other columns are left as they are).
    """
    keys = key.reshape(-1, 2)
    total = keys.shape[0] * m
    if out is None:
        out = torch.empty((total, n), dtype=torch.float32, device=key.device)
    for r0, r1, c0, c1 in draw_blocks(total, padded_dim(n, chunk), chunk):
        c1 = min(c1, n)
        rows = torch.arange(r0, r1, dtype=torch.int64, device=key.device)
        out[r0:r1, c0:c1] = client_uniforms(_row_keys(keys, m, rows, row_offset), c1 - c0, chunk, col0=c0)
    return out


SHARD_BLOCK = 1 << 22  # a shard's coordinates drawn at a time


def shard_uniforms(client_key: torch.Tensor, shape: tuple, local_shape: tuple, offset: tuple,
                   chunk: int = PACK_CHUNK, *, out: torch.Tensor | None = None, bits16: bool = False) -> torch.Tensor:
    """The uniforms that the unsharded ``shape`` leaf's row draws
    (:func:`client_uniforms` of ``client_key``) at the coordinates of a
    shard, in the shard's row-major order: the shard ``local_shape`` starts
    at ``offset`` of the leaf. Every word is a pure function of (key,
    chunk, position in the chunk), so each coordinate takes its chunk's key
    and its own position; a shard of a leaf's inner dimension, whose flat
    order is strided in the leaf's, gets the same bits as a contiguous one.
    Drawn :data:`SHARD_BLOCK` coordinates at a time into ``out`` (a new
    f32 ``(prod(local_shape),)`` when not given). ``bits16`` gives the
    16-bit draws of :func:`client_bits16` instead (int64)."""
    n = 1
    for x in local_shape:
        n *= x
    dev = client_key.device
    if out is None:
        out = torch.empty((n,), dtype=torch.int64 if bits16 else torch.float32, device=dev)
    for a in range(0, n, SHARD_BLOCK):
        e = min(a + SHARD_BLOCK, n)
        g = prng.shard_flat_index(shape, local_shape, offset, a, e, dev)
        j = g // chunk
        # the flat index grows with the shard's: its first and last bound the chunks
        j0 = prng.shard_flat_at(shape, local_shape, offset, a) // chunk
        j1 = prng.shard_flat_at(shape, local_shape, offset, e - 1) // chunk
        keys = prng.fold_in(client_key, torch.arange(j0, j1 + 1, dtype=torch.int64, device=dev))
        kk = keys[j - j0]
        x0, x1 = prng.threefry2x32(kk[:, 0], kk[:, 1], torch.zeros_like(g), g % chunk)
        if bits16:
            out[a:e] = (x0 ^ x1) & 0xFFFF
        else:
            mant = ((x0 ^ x1) >> 9) | 0x3F800000
            out[a:e] = mant.to(torch.int32).view(torch.float32) - 1.0
    return out


def pad_rows(x: torch.Tensor, width: int, value: float) -> torch.Tensor:
    """(M, d) -> f32 (M, width), the pad columns set to ``value``: one
    buffer, written once (no F.pad of a float copy)."""
    m, d = x.shape
    out = torch.empty((m, width), dtype=torch.float32, device=x.device)
    out[:, d:] = value
    out[:, :d] = x
    return out


def _recip32(n: int) -> float:
    """``f32(1 / n)`` as a Python float."""
    return float(np.float32(1.0) / np.float32(n))


def _grid_step(b: torch.Tensor, bits: int) -> torch.Tensor:
    """The k-bit grid step ``2b/(L-1)``, as ``2b * f32(1/(L-1))``."""
    return (2.0 * b) * _recip32((1 << bits) - 1)


def level_positions(delta: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Grid position ``x in [0, L-1]`` of the clipped delta:
    ``(clip(delta, -b, b) + b) / step``; a dead coordinate (``b <= 0``)
    sits at the midpoint ``(L-1)/2``, so its dequantized mean is 0."""
    levels = (1 << bits) - 1
    delta = delta.float()
    b = torch.broadcast_to(b, delta.shape).float()
    delta = torch.clamp(delta, -b, b)
    live = b > 0
    safe_step = torch.where(live, _grid_step(b, bits), torch.ones_like(b))
    x = (delta + b) / safe_step
    return torch.where(live, x, torch.full_like(x, 0.5 * levels))


def level_probs(delta: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-level emission probabilities ``(L,) + delta.shape``: the tent
    ``max(0, 1 - |x - l|)`` of the grid position, at most two nonzero
    entries a coordinate, summing to 1."""
    x = level_positions(delta, b, bits)
    lvls = torch.arange(1 << bits, dtype=torch.float32, device=x.device).reshape((-1,) + (1,) * x.dim())
    return torch.clamp(1.0 - (x.unsqueeze(0) - lvls).abs(), 0.0, 1.0)


def quantize_levels(u: torch.Tensor, delta: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Stochastic grid rounding, uniforms and deltas -> uint8 level indices:
    ``low + 1[u < frac]`` of the grid position; unbiased in the uniforms."""
    levels = (1 << bits) - 1
    x = level_positions(delta, b, bits)
    low = torch.clamp(torch.floor(x), 0.0, float(levels - 1))
    return (low + (u < x - low)).to(torch.uint8)


def dequantize_levels(levels: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Grid value of a level index, ``v_l = -b + l * step``, as one fused
    multiply-add (:func:`repro_torch.prng._fma`, the same on the CPU and
    the card)."""
    b = b.float()
    return prng._fma(levels.float(), _grid_step(b, bits), -b)


def pack_levels(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., n) uint8 levels -> (..., bits * ceil(n/8)) packed planes:
    plane ``p`` (bit ``p`` of every level, packed like the one-bit wire)
    after plane ``p - 1``; an ``n % 8`` tail pads each plane with 0 bits.
    At ``bits = 1`` this is the one-bit wire's layout."""
    if bits not in WIRE_BITS:
        raise ValueError(f"bits must be one of {WIRE_BITS}, got {bits}")
    lv = torch.nn.functional.pad(levels.to(torch.int32), (0, (-levels.shape[-1]) % 8))
    return torch.cat([_pack_bool_lastdim(((lv >> p) & 1).bool()) for p in range(bits)], dim=-1)


def unpack_levels(packed: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_levels`: packed planes -> (..., n) uint8."""
    planes = packed.reshape(packed.shape[:-1] + (bits, -1))
    out = torch.zeros(packed.shape[:-1] + (8 * planes.shape[-1],), dtype=torch.int32, device=packed.device)
    for p in range(bits):
        out |= _unpack_lastdim(planes[..., p, :]).to(torch.int32) << p
    return out[..., :n].to(torch.uint8)


def threshold_u16(p: torch.Tensor) -> torch.Tensor:
    """Eq.-5 probability -> the ``rand_bits=16`` wire's comparison threshold
    ``floor(p * 65536)``, held in int64 (the reference's uint32 domain).

    ``p = 1.0`` (``|delta| >= b``, a certain +1 vote) maps to 65536, above
    every 16-bit draw, so a saturated vote stays certain; a uint16 cast
    would wrap it to 0 and send a certain -1.
    """
    return (p.float() * 65536.0).to(torch.int64)


def packed_binarize_batch(
    key: torch.Tensor,
    deltas: torch.Tensor,
    b: torch.Tensor,
    *,
    chunk: int = PACK_CHUNK,
    want_residual: bool = False,
    row_offset: int = 0,
    rand_bits: int = 32,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Eq.-5 binarize + pack: (M, d) f32 -> (M, padded_dim(d)/8) uint8; or a
    group of E cohorts, keys (E, 2), deltas (E, M, d) and b (E, d) (or
    broadcastable to it) -> (E, M, padded_dim(d)/8).

    Client ``m``'s chunk ``j`` draws from
    ``fold_in(fold_in(key, row_offset + m), j)`` (its element's key in a
    group), exactly the reference's schedule, so the bytes equal the JAX
    wire's. ``rand_bits=16`` compares a 16-bit draw (:func:`client_bits16`)
    with :func:`threshold_u16` instead of an f32 uniform with ``p``: another
    reproducible bit stream, with saturated votes still certain. With
    ``want_residual`` the error-feedback residual ``delta - c * b`` comes
    back with the deltas' shape. Pad coordinates get delta = -1, b = 1, so
    their bit is 0. The group is compressed a block of :func:`draw_blocks`
    at a time, so the draws and the binarize temporaries never span the
    whole (E * M, padded_dim) group, nor a whole row of a very long leaf.
    """
    if rand_bits not in (16, 32):
        raise ValueError(f"rand_bits must be 16 or 32, got {rand_bits}")
    single = key.dim() == 1
    keys = key.reshape(-1, 2)
    e = keys.shape[0]
    m, d = deltas.shape[-2:]
    flat = deltas.reshape(e * m, d)
    d_pad = padded_dim(d, chunk)
    b_rows = torch.as_tensor(b, dtype=torch.float32, device=deltas.device)
    b_rows = torch.broadcast_to(torch.broadcast_to(b_rows, (d,)) if single else b_rows, (e, d))
    b_full = torch.nn.functional.pad(b_rows, (0, d_pad - d), value=1.0)
    packed = torch.empty((e * m, d_pad // 8), dtype=torch.uint8, device=deltas.device)
    res = torch.empty((e * m, d), dtype=torch.float32, device=deltas.device) if want_residual else None
    for r0, r1, c0, c1 in draw_blocks(e * m, d_pad, chunk):
        rows = torch.arange(r0, r1, dtype=torch.int64, device=deltas.device)
        b_blk = (b_full[0] if e == 1 else b_full[rows // m])[..., c0:c1]
        deltas_p = pad_rows(flat[r0:r1, c0:min(c1, d)], c1 - c0, -1.0)
        p = binarize_prob(deltas_p, b_blk)
        ck = _row_keys(keys, m, rows, row_offset)
        if rand_bits == 16:
            bits = client_bits16(ck, c1 - c0, chunk, col0=c0) < threshold_u16(p)
        else:
            bits = client_uniforms(ck, c1 - c0, chunk, col0=c0) < p
        packed[r0:r1, c0 // 8 : c1 // 8] = _pack_bool_lastdim(bits)
        if want_residual and c0 < d:
            res[r0:r1, c0:min(c1, d)] = (deltas_p - torch.where(bits, b_blk, -b_blk))[:, : min(c1, d) - c0]
    shape = deltas.shape[:-1]
    return packed.view(shape + (d_pad // 8,)), None if res is None else res.view(deltas.shape)


def packed_quantize_batch(
    key: torch.Tensor,
    deltas: torch.Tensor,
    b: torch.Tensor,
    *,
    bits: int,
    chunk: int = PACK_CHUNK,
    want_residual: bool = False,
    row_offset: int = 0,
    gamma: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """k-bit quantize + plane pack: (M, d) f32 -> (M, bits * padded_dim(d)/8)
    uint8; or a group of E cohorts, keys (E, 2), deltas (E, M, d), b and
    ``gamma`` (E, d) (or broadcastable to it) -> (E, M, bits *
    padded_dim(d)/8). ``bits = 1`` without ``gamma`` is
    :func:`packed_binarize_batch`.

    The rounding uniforms are the one-bit wire's: chunk ``j`` of client
    ``m`` from ``kj = fold_in(fold_in(key, row_offset + m), j)`` (its
    element's key in a group). ``gamma`` (a scalar or ``(d,)``, one row a
    run in a group) arms L-level randomized response: where the uniform of
    ``fold_in(kj, 1)`` is below ``gamma`` the level is replaced by
    ``randint(fold_in(kj, 2), 0, L)`` (the reference draws it as uint8,
    the low byte of the same 32-bit word, which for a span dividing 256 is
    the int32 draw). Pad coordinates get delta -1, b 1 and gamma 0, so
    every plane of theirs is 0. With ``want_residual`` the error-feedback
    residual ``delta - v(level)`` of the emitted level comes back too.
    Every step is a function of one coordinate, so a group's rows are its
    runs' own; the group's rows are drawn :func:`uniform_block_rows` at a
    time.
    """
    if bits not in WIRE_BITS:
        raise ValueError(f"bits must be one of {WIRE_BITS}, got {bits}")
    if bits == 1 and gamma is None:
        return packed_binarize_batch(key, deltas, b, chunk=chunk, want_residual=want_residual,
                                     row_offset=row_offset)
    single = key.dim() == 1
    keys = key.reshape(-1, 2)
    e = keys.shape[0]
    m, d = deltas.shape[-2:]
    dev = deltas.device
    d_pad = padded_dim(d, chunk)
    flat = deltas.reshape(e * m, d)

    def per_run(x, pad):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        x = torch.broadcast_to(torch.broadcast_to(x, (d,)) if single else x, (e, d))
        return pad_rows(x, d_pad, pad)

    b_full = per_run(b, 1.0)
    g_full = None if gamma is None else per_run(gamma, 0.0)
    packed = torch.empty((e * m, bits * d_pad // 8), dtype=torch.uint8, device=dev)
    res = torch.empty((e * m, d), dtype=torch.float32, device=dev) if want_residual else None
    chunks = torch.arange(d_pad // chunk, dtype=torch.int64, device=dev)
    block = uniform_block_rows(d_pad)
    for r0 in range(0, e * m, block):
        r1 = min(r0 + block, e * m)
        rows = torch.arange(r0, r1, dtype=torch.int64, device=dev)
        kj = prng.fold_in(_row_keys(keys, m, rows, row_offset).unsqueeze(-2), chunks)  # (rows, chunks, 2)
        deltas_p = pad_rows(flat[r0:r1], d_pad, -1.0)
        b_rows = b_full[0] if e == 1 else b_full[rows // m]
        lvl = quantize_levels(prng.uniform(kj, (chunk,)).reshape(r1 - r0, d_pad), deltas_p, b_rows, bits)
        if g_full is not None:
            gate = prng.uniform(prng.fold_in(kj, 1), (chunk,)).reshape(r1 - r0, d_pad)
            rand = prng.randint(prng.fold_in(kj, 2), (chunk,), 0, 1 << bits).reshape(r1 - r0, d_pad)
            lvl = torch.where(gate < (g_full[0] if e == 1 else g_full[rows // m]), rand.to(torch.uint8), lvl)
        packed[r0:r1] = pack_levels(lvl, bits)
        if want_residual:
            res[r0:r1] = (deltas_p - dequantize_levels(lvl, b_rows, bits))[:, :d]
    shape = deltas.shape[:-1]
    return packed.view(shape + (packed.shape[-1],)), None if res is None else res.view(deltas.shape)


def packed_sign_batch(deltas: torch.Tensor, *, chunk: int = PACK_CHUNK) -> torch.Tensor:
    """Deterministic sign codes (the signSGD-MV / RSA wire): bit =
    ``delta >= 0``, (..., M, d) -> (..., M, padded_dim(d)/8) uint8; pad
    coordinates (delta -1) pack 0."""
    d = deltas.shape[-1]
    packed = _pack_bool_lastdim(pad_rows(deltas.reshape(-1, d), padded_dim(d, chunk), -1.0) >= 0)
    return packed.view(deltas.shape[:-1] + packed.shape[-1:])


def packed_counts(packed: torch.Tensor) -> torch.Tensor:
    """Vote counts ``N_i`` from the packed wire: (M, P) uint8 -> (8P,) int32.

    Counts accumulate in int32, never in the uint8 wire dtype, which would
    wrap past 255 clients. The reference reduces by octet transpose and
    popcount; the integers are the same.
    """
    return _unpack_lastdim(packed).sum(0, dtype=torch.int32)


WEIGHTED_BLOCK_WORDS = 1 << 26  # f32 words of one unpacked block of the weighted count: 256 MiB


def packed_residuals(packed: torch.Tensor, deltas: torch.Tensor, b: torch.Tensor, *,
                     chunk: int = PACK_CHUNK) -> torch.Tensor:
    """The error-feedback residual ``delta - c * b`` recovered from a wire
    whose codes an external compressor packed: (M, P) uint8 and (M, d)
    deltas -> (M, d) f32. The wire is cut or zero-padded to
    ``padded_dim(d)/8`` bytes first, as the reference pads it."""
    m, d = deltas.shape
    target = padded_dim(d, chunk) // 8
    packed = packed[:, :target]
    packed = torch.nn.functional.pad(packed, (0, target - packed.shape[1]))
    bits = _unpack_lastdim(packed)[:, :d].bool()
    b = torch.broadcast_to(torch.as_tensor(b, dtype=torch.float32, device=deltas.device), (d,))
    return deltas.float() - torch.where(bits, b, -b)


def packed_weighted_counts(packed: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted vote counts ``N_i^w = sum_m w_m 1[c_i^m = +1]``: (M, P) uint8
    and (M,) weights -> (8P,) f32.

    The wire is unpacked to f32 a block of bytes at a time, as many as keep
    the block near ``WEIGHTED_BLOCK_WORDS`` words (the reference walks one
    chunk at a time; each count sums over the clients only, so with integer
    weights the block width changes no count, while torch's order of a
    fractional sum, and so its last bit, may depend on it). With unit or
    0/1 weights the result equals :func:`packed_counts` exactly: an f32 sum
    of {0, 1} terms is exact below 2**24 clients.
    """
    m, p = packed.shape
    w = weights.float().reshape(m, 1)
    block = max(1, WEIGHTED_BLOCK_WORDS // (8 * max(m, 1)))
    out = torch.empty((8 * p,), dtype=torch.float32, device=packed.device)
    for j0 in range(0, p, block):
        j1 = min(j0 + block, p)
        out[8 * j0 : 8 * j1] = (_unpack_lastdim(packed[:, j0:j1]).float() * w).sum(0)
    return out
