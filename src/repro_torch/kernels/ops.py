"""Public wrappers around the CUDA kernels, with engine dispatch.

Counterpart of ``repro/kernels/ops.py``. Two engines:

* ``"cuda"`` — the hand-written Hopper kernels (``csrc/*.cu``);
* ``"ref"``  — plain PyTorch (:mod:`repro_torch.kernels.ref` and the
  :mod:`repro_torch.core.quantizer` primitives), bit-identical to the
  kernels and the engine of every CPU tensor.

:func:`resolve_engine` is the policy: an explicit ``engine=`` wins;
otherwise a CUDA tensor resolves to ``"cuda"`` and a CPU tensor to
``"ref"``. A kernel that fails to build or launch raises; nothing falls
back to ``"ref"``.

The reference has no kernel for the k-bit wire (``bits > 1``): there
``stoch_quant_compress_batch`` quantizes with plain torch on every engine,
as the reference routes it through plain JAX on every backend; that is the
reference's structure, not a fallback. :func:`quant_pack_u` binarizes and
packs values with uniforms the caller drew (the top-k wire's gathered
values) through the pack kernel B1. :func:`stoch_quant_compress` and
:func:`stoch_quant_pack` are the reference's single-client entries: one
client's row, keyed by the client's own key, through the same row
compressor as the batch entry (:func:`_compress_rows`).

Wire format: the kernel wire is ``padded_len(d)/8`` bytes a row
(1024-coordinate rows, the reference's TPU tile, kept because it defines
the wire). Pad coordinates carry delta = -1, b = 1, u = 1.0, so pad bits
are 0. Both engines emit this width; the ``ref`` engine realigns the
chunked packer's ``padded_dim(d)/8`` row losslessly, as the reference does.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..core.quantizer import (
    PACK_CHUNK,
    client_uniforms,
    cohort_uniforms,
    draw_blocks,
    packed_binarize_batch,
    packed_quantize_batch,
    pad_rows,
    padded_dim,
)
from . import ref, stoch_quant

__all__ = [
    "ENGINES",
    "LANES",
    "resolve_engine",
    "padded_len",
    "realign_wire",
    "prox_coeffs",
    "stoch_quant_compress",
    "stoch_quant_pack",
    "stoch_quant_compress_batch",
    "quant_pack_u",
    "bit_aggregate",
    "prox_sgd",
]

ENGINES = ("cuda", "ref")
LANES = 1024  # coordinates per kernel-wire row; packs to 128 bytes


def resolve_engine(engine: str | None = None, device=None) -> str:
    """Explicit ``engine`` wins; else a CUDA device -> "cuda", any other -> "ref"."""
    if engine is not None:
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        return engine
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def padded_len(n: int) -> int:
    return ((n + LANES - 1) // LANES) * LANES


def realign_wire(packed: torch.Tensor, target: int) -> torch.Tensor:
    """Cut or zero-pad packed rows (the last axis) to ``target`` bytes (pad
    bits are 0)."""
    width = packed.shape[-1]
    if width > target:
        return packed[..., :target].contiguous()
    if width < target:
        return F.pad(packed, (0, target - width))
    return packed


def prox_coeffs(eta, lam, mu, device=None) -> torch.Tensor:
    """The f32 ``coeffs`` of :func:`prox_sgd`: ``(1, 3)`` from Python
    numbers (made once per value and device: a copy to the card waits for
    it, so a run's rounds reuse one), ``(E, 3)`` from ``(E,)`` tensors (one
    row per element)."""
    if not torch.is_tensor(eta):
        return _number_coeffs(float(eta), float(lam), float(mu), torch.device(device or "cpu"))
    return torch.stack([eta, lam, mu], dim=-1).to(device=device, dtype=torch.float32).contiguous()


@functools.lru_cache(maxsize=64)
def _number_coeffs(eta: float, lam: float, mu: float, device: torch.device) -> torch.Tensor:
    return torch.tensor([[eta, lam, mu]], dtype=torch.float32, device=device)


def _as_group(key: torch.Tensor, deltas: torch.Tensor, b: torch.Tensor):
    """(keys (E, 2), deltas (E, M, d), b (E, d)) of a compress call: one
    run's (2,) key, (M, d) cohort and (d,) range are a group of one."""
    if key.dim() == 1:
        key, deltas = key.unsqueeze(0), deltas.unsqueeze(0)
        b = torch.as_tensor(b, dtype=torch.float32, device=deltas.device).reshape(1, -1)
    e, _, d = deltas.shape
    return key, deltas, torch.broadcast_to(b.float(), (e, d))


def _compress_rows(u: torch.Tensor, deltas: torch.Tensor, b_rows: torch.Tensor, residual: torch.Tensor | None,
                   want_residual: bool, engine: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Eq.-5 compress of the (R, d) rows ``deltas`` with uniforms already
    drawn into ``u`` (R, width), its pad columns 1.0: the rows are padded to
    ``width`` (delta -1, b 1, residual 0), then packed by B1, or by B2 when a
    residual is given or wanted (the plain version on ``engine="ref"``).
    ``b_rows`` (E, d) ranges the R rows as E elements. Returns (packed (R,
    width/8) uint8, the next carry (R, d) or None)."""
    width, d = u.shape[-1], deltas.shape[-1]
    d_p, b_p = pad_rows(deltas, width, -1.0), pad_rows(b_rows, width, 1.0)
    r_p = None if residual is None else pad_rows(residual, width, 0.0)
    if engine == "ref":
        packed, res = ref.stoch_quant_compress_ref(d_p, b_p, u, r_p, want_residual=want_residual)
    elif r_p is None and not want_residual:
        packed, res = stoch_quant.stoch_quant_pack(d_p, b_p, u), None
    else:
        packed, res = stoch_quant.stoch_quant_ef(d_p, torch.zeros_like(d_p) if r_p is None else r_p, b_p, u)
    return packed, res[:, :d] if want_residual else None


def stoch_quant_compress(
    key: torch.Tensor,
    delta: torch.Tensor,
    b: torch.Tensor,
    residual: torch.Tensor | None = None,
    *,
    chunk: int = PACK_CHUNK,
    want_residual: bool = False,
    engine: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Eq.-5 compress of one client onto the kernel wire: (N,) ``delta``, a
    scalar or (N,) ``b`` -> (packed (padded_len(N)/8,) uint8, the next
    error-feedback carry (N,) f32 or None).

    ``key`` is the client's own key (the caller has folded in its cohort
    position): the uniforms are ``client_uniforms(key, N, chunk)``, so the
    bytes are :func:`stoch_quant_compress_batch`'s row of this client.
    ``residual`` is added to ``delta`` first; ``want_residual`` returns the
    next carry ``eff - c * b``. Pad coordinates get delta -1, b 1 and u 1.
    On ``"cuda"`` one launch of B1, or of B2 with a residual given or
    wanted; on ``"ref"`` the plain version.
    """
    engine = resolve_engine(engine, delta.device)
    n = delta.shape[0]
    u = torch.ones((1, padded_len(n)), dtype=torch.float32, device=delta.device)
    for _, _, c0, c1 in draw_blocks(1, padded_dim(n, chunk), chunk):
        u[0, c0:min(c1, n)] = client_uniforms(key, min(c1, n) - c0, chunk, col0=c0)
    b_row = torch.broadcast_to(torch.as_tensor(b, dtype=torch.float32, device=delta.device), (n,)).reshape(1, n)
    packed, res = _compress_rows(u, delta.reshape(1, n), b_row, None if residual is None else residual.reshape(1, n),
                                 want_residual, engine)
    return packed[0], None if res is None else res[0]


def stoch_quant_pack(key: torch.Tensor, delta: torch.Tensor, b: torch.Tensor, *, chunk: int = PACK_CHUNK,
                     engine: str | None = None) -> torch.Tensor:
    """One client's (N,) ``delta`` -> packed (padded_len(N)/8,) uint8:
    :func:`stoch_quant_compress` without error feedback (B1)."""
    return stoch_quant_compress(key, delta, b, chunk=chunk, engine=engine)[0]


def stoch_quant_compress_batch(
    key: torch.Tensor,
    deltas: torch.Tensor,
    b: torch.Tensor,
    *,
    residual: torch.Tensor | None = None,
    row_offset: int = 0,
    chunk: int = PACK_CHUNK,
    want_residual: bool = False,
    engine: str | None = None,
    bits: int = 1,
    gamma: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Eq.-5 compress of an (M, d) cohort onto the kernel wire, or of a
    group of E cohorts at once: keys (E, 2), deltas (E, M, d), b (E, d).

    ``bits > 1`` (one cohort) emits the plane-major k-bit wire of
    :func:`~repro_torch.core.quantizer.packed_quantize_batch` (with
    randomized response when ``gamma`` is given), each plane realigned to
    ``padded_len(d)/8`` bytes: (M, bits * padded_len(d)/8). The reference
    has no kernel for it and quantizes with plain JAX on every backend; so
    does the port, with plain torch on either engine.

    Client ``i`` of element ``e`` draws from ``fold_in(key[e], row_offset +
    i)`` on the ``client_uniforms`` chunk schedule, so both engines emit
    the JAX wire's bytes (a group equals E separate calls). The kernel
    engine draws the uniforms in blocks of client rows
    (``cohort_uniforms``) into one padded (E * M, padded_len) buffer and
    launches one kernel over the whole group; the ``ref`` engine
    compresses block by block (``packed_binarize_batch``). ``residual`` is
    the error-feedback carry added to the deltas first (fused into the
    kernel); with ``want_residual`` the next carry ``eff - c * b`` comes
    back. ``b`` is the public range, (d,) or a scalar for one cohort.

    Returns (packed (M, padded_len(d)/8) uint8, residuals (M, d) or None),
    with a leading E for a group.
    """
    engine = resolve_engine(engine, deltas.device)
    if bits > 1 or gamma is not None:
        eff = deltas if residual is None else deltas + residual
        packed, res = packed_quantize_batch(key, eff, b, bits=bits, chunk=chunk, want_residual=want_residual,
                                            row_offset=row_offset, gamma=gamma)
        m, d = deltas.shape
        planes = realign_wire(packed.view(m, bits, -1), padded_len(d) // 8)
        return planes.reshape(m, -1), res
    single = key.dim() == 1
    keys, group, b_rows = _as_group(key, deltas, b)
    e, m, d = group.shape
    target = padded_len(d) // 8
    if residual is not None:
        residual = residual.reshape(group.shape)
    if engine == "ref":
        eff = group if residual is None else group + residual
        packed, res = packed_binarize_batch(
            keys, eff, b_rows, chunk=chunk, want_residual=want_residual, row_offset=row_offset
        )
        packed = realign_wire(packed, target)
    else:
        u = torch.empty((e * m, 8 * target), dtype=torch.float32, device=deltas.device)
        u[:, d:] = 1.0
        cohort_uniforms(keys, m, d, chunk, row_offset=row_offset, out=u)
        packed, res = _compress_rows(u, group.reshape(e * m, d), b_rows,
                                     None if residual is None else residual.reshape(e * m, d), want_residual, engine)
        res = None if res is None else res.reshape(e, m, d)
        packed = packed.view(e, m, target)
    if single:
        return packed[0], None if res is None else res[0]
    return packed, res


def quant_pack_u(delta: torch.Tensor, b: torch.Tensor, uniforms: torch.Tensor, *,
                 engine: str | None = None) -> torch.Tensor:
    """Eq.-5 binarize + pack of values with the caller's uniforms (the top-k
    wire's gathered values): ``delta``, ``b`` and ``uniforms`` (K,) give
    (padded_len(K)/8,) uint8; (R, K) rows give (R, padded_len(K)/8), row
    ``r`` ranged by its own row of ``b``, in one launch of the pack kernel
    (B1 with E = R elements of one row each). Pad coordinates get delta
    -1, b 1 and u 1.0, so the first ``ceil(K/8)`` bytes of a row are
    ``pack_bits`` of its codes."""
    engine = resolve_engine(engine, delta.device)
    d2, b2, u2 = (t.reshape(-1, t.shape[-1]) for t in (delta, torch.broadcast_to(b, delta.shape), uniforms))
    packed, _ = _compress_rows(pad_rows(u2, padded_len(d2.shape[-1]), 1.0), d2, b2, None, False, engine)
    return packed[0] if delta.dim() == 1 else packed


def bit_aggregate(packed: torch.Tensor, b: torch.Tensor, n: int, *, engine: str | None = None) -> torch.Tensor:
    """packed (M, P) uint8, b (n,) or a scalar -> theta_hat (n,) f32 (Eq. 13);
    or a group of E elements, packed (E, M, P) and b (E, n) -> (E, n).

    Pad coordinates (>= n) never reach the estimate: both engines take b at
    its true length n.
    """
    engine = resolve_engine(engine, packed.device)
    b_full = torch.broadcast_to(b.float(), packed.shape[:-2] + (n,))
    if engine == "ref":
        return ref.bit_aggregate_ref(packed, b_full)
    from .bit_aggregate import bit_aggregate as kernel

    return kernel(packed.contiguous(), b_full.contiguous())


def prox_sgd(w, w0, grad, momentum, coeffs, *, out=None, engine: str | None = None):
    """Fused prox-SGD step on the rows of E elements (an (M, d) cohort, or
    one (d,) row, is one element): ``w0`` (E, d) holds each element's global
    model ((d,) for one) and ``coeffs`` (E, 3) its ``(eta, lam, mu)``, or
    (1, 3) for all (:func:`prox_coeffs`). Returns (w_new, momentum_new),
    written into ``out=(w_out, m_out)`` when it is given: contiguous
    buffers of ``w``'s shape, where ``w_out`` may be ``w`` and ``m_out``
    ``momentum`` (an update in place). Both engines take the same ``out``."""
    engine = resolve_engine(engine, w.device)
    if engine == "ref":
        if out is not None:
            from .prox_sgd import check_out

            out = check_out(out, w, w0, grad, momentum)
        return ref.prox_sgd_ref(w, w0, grad, momentum, coeffs, out=out)
    from .prox_sgd import prox_sgd as kernel

    return kernel(w.contiguous(), w0.contiguous(), grad.contiguous(), momentum.contiguous(), coeffs.contiguous(),
                  out=out)
