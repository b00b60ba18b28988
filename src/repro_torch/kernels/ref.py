"""Plain PyTorch versions of the four hand-written CUDA kernels.

Counterpart of ``repro/kernels/ref.py``. Each function computes exactly
what its kernel computes, with the same f32 operation order, so the kernel
can be held to it bit for bit on the card. The CPU path and the tests run
these; on a CUDA tensor nothing on the main path calls them unless
``engine="ref"`` is passed explicitly.

``kbit_quant_compress_ref`` and ``kbit_aggregate_ref`` are the plain k-bit
pair (the reference has no kernel for ``bits > 1``; these are what its
``ref.py`` holds for that wire, not versions of a kernel of the port).

Each kernel version takes a group of E elements (a campaign group's (cell, seed) runs)
in one call: the rows of element ``e`` are rows ``e * R/E .. (e+1) * R/E - 1``
of the ``R`` rows given, and each element has its own range ``b``, its own
global model ``w0`` and its own step coefficients. E = 1 is the single
run.
"""

from __future__ import annotations

import torch

from ..core.quantizer import _pack_bool_lastdim, _unpack_lastdim, binarize_prob

__all__ = ["element_rows", "stoch_quant_compress_ref", "stoch_quant_pack_ref", "bit_aggregate_ref", "kbit_quant_compress_ref",
           "kbit_aggregate_ref", "prox_sgd_ref"]


def element_rows(rows: int, elements: int) -> int:
    """Rows of one element when ``rows`` rows split into ``elements``
    equal elements; raises when they do not."""
    if elements < 1 or rows % elements:
        raise ValueError(f"{rows} rows do not split into {elements} elements")
    return rows // elements


def stoch_quant_compress_ref(
    delta: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    residual: torch.Tensor | None = None,
    *,
    want_residual: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """EF-add + Eq.-5 binarize + LSB-first 8:1 pack (kernels B1 and B2).

    ``delta``/``uniforms`` (R, N) f32 with N % 8 == 0; ``b`` (N,), or
    (E, N) with row ``r`` ranged by ``b[r // (R/E)]``. Returns
    ((R, N/8) uint8, the next EF carry ``eff - c * b`` or None).
    """
    eff = delta.float()
    if residual is not None:
        eff = eff + residual.float()
    if b.dim() == 2:
        per = element_rows(eff.shape[0], b.shape[0])
        b = b.repeat_interleave(per, dim=0) if b.shape[0] > 1 else b
    b = torch.broadcast_to(b, eff.shape).float()
    bits = uniforms < binarize_prob(eff, b)
    packed = _pack_bool_lastdim(bits)
    if not want_residual:
        return packed, None
    return packed, eff - torch.where(bits, b, -b)


def stoch_quant_pack_ref(delta: torch.Tensor, b: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Eq.-5 binarize + pack without error feedback (kernel B1)."""
    return stoch_quant_compress_ref(delta, b, uniforms)[0]


def bit_aggregate_ref(packed: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vote-count M clients' packed codes, then the Eq.-13 estimate (B3).

    packed (M, P) uint8 and b (N,) f32 with N <= 8P -> theta_hat (N,) f32;
    or a group, packed (E, M, P) and b (E, N) -> (E, N), each element
    counted over its own M rows.
    """
    from ..core.aggregation import ml_estimate_from_counts

    counts = _unpack_lastdim(packed).sum(-2, dtype=torch.int32)[..., : b.shape[-1]]
    return ml_estimate_from_counts(counts, packed.shape[-2], b)


def kbit_quant_compress_ref(
    delta: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    *,
    bits: int,
    residual: torch.Tensor | None = None,
    want_residual: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """k-bit sibling of :func:`stoch_quant_compress_ref`: EF-add, stochastic
    rounding onto the ``2**bits``-level grid in [-b, b] and plane packing,
    (..., N) -> (..., bits * N/8) uint8, with the next EF carry ``eff -
    v(level)``. ``bits = 1`` gives the one-bit wire byte for byte."""
    from ..core.quantizer import dequantize_levels, pack_levels, quantize_levels

    eff = delta.float()
    if residual is not None:
        eff = eff + residual.float()
    b = torch.broadcast_to(b, eff.shape).float()
    levels = quantize_levels(uniforms, eff, b, bits)
    packed = pack_levels(levels, bits)
    if not want_residual:
        return packed, None
    return packed, eff - dequantize_levels(levels, b, bits)


def kbit_aggregate_ref(packed: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Count each bit plane of an (M, bits * P) wire, then the L-level ML
    estimate (:func:`~repro_torch.core.aggregation.kbit_estimate_from_counts`)
    of the first ``N = len(b)`` coordinates."""
    from ..core.aggregation import kbit_estimate_from_counts

    plane_counts = _unpack_lastdim(packed).sum(0, dtype=torch.int32).reshape(bits, -1)[:, : b.shape[0]]
    return kbit_estimate_from_counts(plane_counts, packed.shape[0], b, bits)


def prox_sgd_ref(w, w0, grad, momentum, coeffs, *, out=None):
    """Fused prox-regularized SGD+momentum step (Eq. 4 local solver, B4).

    w, grad, momentum (R, d); w0 (E, d), the global model of each of E
    elements of R/E rows (a (d,) row is one element); coeffs (E, 3) or
    (1, 3) f32, each element's ``(eta, lam, mu)``.
    g = grad + lam (w - w0); m' = mu m + g; w' = w - eta m' — one rounding
    per operation, no fused multiply-add. ``out=(w_out, m_out)`` receives
    the result; ``w_out`` may be ``w`` and ``m_out`` ``momentum`` (m' is
    written after g is formed and before w' reads it, w' last).
    """
    d = w.shape[-1]
    w0 = w0.reshape(-1, d)
    e = w0.shape[0]
    per = element_rows(w.numel() // d, e)
    shape = (e, per, d)

    def by_element(t):
        return t.reshape(shape)

    eta, lam, mu = (coeffs[:, k].reshape(-1, 1, 1) for k in range(3))
    g = by_element(grad) + lam * (by_element(w) - w0.unsqueeze(1))
    if out is None:
        new_m = mu * by_element(momentum) + g
        return (by_element(w) - eta * new_m).reshape(w.shape), new_m.reshape(w.shape)
    w_out, m_out = out
    torch.add(mu * by_element(momentum), g, out=by_element(m_out))
    torch.sub(by_element(w), eta * by_element(m_out), out=by_element(w_out))
    return w_out, m_out
