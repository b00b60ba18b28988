"""Plain PyTorch versions of the four hand-written CUDA kernels.

Counterpart of ``repro/kernels/ref.py``. Each function computes exactly
what its kernel computes, with the same f32 operation order, so the kernel
can be held to it bit for bit on the card. The CPU path and the tests run
these; on a CUDA tensor nothing on the main path calls them unless
``engine="ref"`` is passed explicitly.
"""

from __future__ import annotations

import torch

from ..core.quantizer import _pack_bool_lastdim, binarize_prob, packed_counts


def stoch_quant_compress_ref(
    delta: torch.Tensor,
    b: torch.Tensor,
    uniforms: torch.Tensor,
    residual: torch.Tensor | None = None,
    *,
    want_residual: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """EF-add + Eq.-5 binarize + LSB-first 8:1 pack (kernels B1 and B2).

    ``delta``/``uniforms`` (..., N) f32 with N % 8 == 0, ``b`` broadcast
    against them. Returns ((..., N/8) uint8, the next EF carry
    ``eff - c * b`` or None).
    """
    eff = delta.float()
    if residual is not None:
        eff = eff + residual.float()
    b = torch.broadcast_to(b, eff.shape).float()
    bits = uniforms < binarize_prob(eff, b)
    packed = _pack_bool_lastdim(bits)
    if not want_residual:
        return packed, None
    return packed, eff - torch.where(bits, b, -b)


def bit_aggregate_ref(packed: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vote-count M clients' packed codes, then the Eq.-13 estimate (B3).

    packed (M, P) uint8, b (N,) f32 with N <= 8P -> theta_hat (N,) f32.
    """
    from ..core.aggregation import ml_estimate_from_counts

    counts = packed_counts(packed)[: b.shape[0]]
    return ml_estimate_from_counts(counts, packed.shape[0], b)


def prox_sgd_ref(w, w0, grad, momentum, eta: float, lam: float, mu: float, *, out=None):
    """Fused prox-regularized SGD+momentum step (Eq. 4 local solver, B4).

    g = grad + lam (w - w0); m' = mu m + g; w' = w - eta m' — one rounding
    per operation, no fused multiply-add. ``out=(w_out, m_out)`` receives
    the result; ``w_out`` may be ``w`` and ``m_out`` ``momentum`` (m' is
    written after g is formed and before w' reads it, w' last).
    """
    g = grad + lam * (w - w0)
    if out is None:
        new_m = mu * momentum + g
        return w - eta * new_m, new_m
    w_out, m_out = out
    torch.add(mu * momentum, g, out=m_out)
    return torch.sub(w, eta * m_out, out=w_out), m_out
