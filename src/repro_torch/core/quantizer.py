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
chunks use. The k-bit level grid and the 16-bit draws of the reference
come with later slices of the port.
"""

from __future__ import annotations

import torch

from .. import prng

__all__ = [
    "PACK_CHUNK",
    "wire_bytes",
    "binarize_prob",
    "pack_bits",
    "unpack_bits",
    "padded_dim",
    "client_uniforms",
    "uniform_block_rows",
    "cohort_uniforms",
    "pad_rows",
    "packed_binarize_batch",
    "packed_sign_batch",
    "packed_counts",
    "packed_weighted_counts",
]

PACK_CHUNK = 8192  # coordinates per uniform-draw chunk (multiple of 8)


def wire_bytes(d: int, bits: int = 1, *, d_pad: int | None = None) -> int:
    """Uplink bytes of one client's packed wire row (``bits`` per value).

    ``d_pad`` is the padded coordinate count the producing wire emits
    (``padded_dim`` for the chunked packer, ``ops.padded_len`` for the
    kernel wire); ``None`` gives the unpadded ``ceil(d/8)`` floor.
    """
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


def padded_dim(d: int, chunk: int = PACK_CHUNK) -> int:
    """Chunked-wire dimension: ``d`` rounded up to whole chunks."""
    return ((d + chunk - 1) // chunk) * chunk


def client_uniforms(client_key: torch.Tensor, n: int, chunk: int = PACK_CHUNK) -> torch.Tensor:
    """The ``(n,)`` quantizer uniforms of a client, counter-derived per chunk.

    Chunk ``j`` draws ``uniform(fold_in(client_key, j), (chunk,))``, the
    schedule of the reference's ``client_uniforms`` and
    ``packed_binarize_batch``. Keys ``(..., 2)`` give ``(..., n)``, one row
    of uniforms per key.
    """
    n_chunks = padded_dim(n, chunk) // chunk
    j = torch.arange(n_chunks, dtype=torch.int64, device=client_key.device)
    chunk_keys = prng.fold_in(client_key.unsqueeze(-2), j)
    u = prng.uniform(chunk_keys, (chunk,))
    return u.reshape(client_key.shape[:-1] + (-1,))[..., :n]


UNIFORM_BLOCK_WORDS = 1 << 27  # Threefry words per draw block: 1 GiB per int64 temporary


def uniform_block_rows(n: int) -> int:
    """Client rows per uniform-draw block for ``n`` coordinates a row, so
    that each int64 temporary of the Threefry stream stays near 1 GiB
    (100 rows at the MLP's width, 12 at ResNet-18's)."""
    return max(1, UNIFORM_BLOCK_WORDS // n)


def _row_uniforms(keys: torch.Tensor, m: int, rows: torch.Tensor, n: int, chunk: int, row_offset: int):
    """The uniforms of flat group rows ``rows``: row ``r`` is client
    ``row_offset + r % m`` of element ``r // m``, keyed by ``keys[r // m]``."""
    return client_uniforms(prng.fold_in(keys[rows // m], row_offset + rows % m), n, chunk)


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

    Drawn :func:`uniform_block_rows` rows of the group at a time into
    ``out[:, :n]``, which may be wider (its other columns are left as they
    are). Each draw is a pure function of (key, row, chunk), so any block
    size gives the same bits.
    """
    keys = key.reshape(-1, 2)
    total = keys.shape[0] * m
    if out is None:
        out = torch.empty((total, n), dtype=torch.float32, device=key.device)
    block = uniform_block_rows(padded_dim(n, chunk))
    for r0 in range(0, total, block):
        r1 = min(r0 + block, total)
        rows = torch.arange(r0, r1, dtype=torch.int64, device=key.device)
        out[r0:r1, :n] = _row_uniforms(keys, m, rows, n, chunk, row_offset)
    return out


def pad_rows(x: torch.Tensor, width: int, value: float) -> torch.Tensor:
    """(M, d) -> f32 (M, width), the pad columns set to ``value``: one
    buffer, written once (no F.pad of a float copy)."""
    m, d = x.shape
    out = torch.empty((m, width), dtype=torch.float32, device=x.device)
    out[:, d:] = value
    out[:, :d] = x
    return out


def packed_binarize_batch(
    key: torch.Tensor,
    deltas: torch.Tensor,
    b: torch.Tensor,
    *,
    chunk: int = PACK_CHUNK,
    want_residual: bool = False,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Eq.-5 binarize + pack: (M, d) f32 -> (M, padded_dim(d)/8) uint8; or a
    group of E cohorts, keys (E, 2), deltas (E, M, d) and b (E, d) (or
    broadcastable to it) -> (E, M, padded_dim(d)/8).

    Client ``m``'s chunk ``j`` draws from
    ``fold_in(fold_in(key, row_offset + m), j)`` (its element's key in a
    group), exactly the reference's schedule, so the bytes equal the JAX
    wire's. With ``want_residual`` the error-feedback residual
    ``delta - c * b`` comes back with the deltas' shape. Pad coordinates get
    delta = -1, b = 1, so their bit is 0. The rows are compressed
    :func:`uniform_block_rows` at a time over the whole group, so the
    uniforms and the binarize temporaries never span the whole (E * M,
    padded_dim) group.
    """
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
    block = uniform_block_rows(d_pad)
    for r0 in range(0, e * m, block):
        r1 = min(r0 + block, e * m)
        rows = torch.arange(r0, r1, dtype=torch.int64, device=deltas.device)
        b_blk = b_full[0] if e == 1 else b_full[rows // m]
        deltas_p = pad_rows(flat[r0:r1], d_pad, -1.0)
        u = _row_uniforms(keys, m, rows, d_pad, chunk, row_offset)
        bits = u < binarize_prob(deltas_p, b_blk)
        packed[r0:r1] = _pack_bool_lastdim(bits)
        if want_residual:
            res[r0:r1] = (deltas_p - torch.where(bits, b_blk, -b_blk))[:, :d]
    shape = deltas.shape[:-1]
    return packed.view(shape + (d_pad // 8,)), None if res is None else res.view(deltas.shape)


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
