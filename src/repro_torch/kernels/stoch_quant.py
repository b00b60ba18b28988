"""Bindings of the fused Eq.-5 quantize + pack kernels (B1, B2).

``stoch_quant_pack`` replaces the Pallas ``stoch_quant_pack_2d`` and
``stoch_quant_ef_2d`` the Pallas ``stoch_quant_ef_2d``
(``repro/kernels/stoch_quant.py``); the CUDA source is
``csrc/stoch_quant.cu``. Both take all ``R`` rows of a group of E elements
in one launch (the ``(M, d_pad)`` cohort of one run is E = 1), with the
range ``b`` as one ``(d_pad,)`` row per element: ``(E, d_pad)``, or one
``(d_pad,)`` row for E = 1.

On a CPU tensor the wrappers compute the plain version
(:func:`repro_torch.kernels.ref.stoch_quant_compress_ref`); on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["stoch_quant_pack", "stoch_quant_ef"]


def _check_args(delta, b, u, residual=None):
    """(rows, d_pad, rows of one element) of a valid call, else ValueError."""
    m, d_pad = delta.shape
    if d_pad % 8:
        raise ValueError(f"row length must be a multiple of 8, got {d_pad}")
    if b.dim() not in (1, 2):
        raise ValueError(f"b: need (d_pad,) or (E, d_pad), got {tuple(b.shape)}")
    per = ref.element_rows(m, b.shape[0] if b.dim() == 2 else 1)
    for name, t, shape in (("delta", delta, (m, d_pad)), ("u", u, (m, d_pad)),
                           ("b", b, b.shape[:-1] + (d_pad,)), ("residual", residual, (m, d_pad))):
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous f32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != delta.device:
            raise ValueError(f"{name} is on {t.device}, delta on {delta.device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel")
    if delta.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {delta.device}")
    return m, d_pad, per


def stoch_quant_pack(delta: torch.Tensor, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """delta, u (R, d_pad) f32, b (d_pad,) or (E, d_pad) f32 -> packed
    (R, d_pad/8) uint8; row r is ranged by b's row r // (R/E)."""
    m, d_pad, per = _check_args(delta, b, u)
    if delta.device.type == "cpu":
        return ref.stoch_quant_compress_ref(delta, b, u)[0]
    out = torch.empty((m, d_pad // 8), dtype=torch.uint8, device=delta.device)
    lib = _build.library("stoch_quant")
    rc = lib.probit_stoch_quant_pack(
        delta.data_ptr(), b.data_ptr(), u.data_ptr(), out.data_ptr(), m, d_pad, per,
        torch.cuda.current_stream(delta.device).cuda_stream,
    )
    _build.check(rc, "stoch_quant_pack")
    return out


def stoch_quant_ef(
    delta: torch.Tensor, residual: torch.Tensor, b: torch.Tensor, u: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused EF compress: eff = delta + residual, pack Eq.-5 bits of eff,
    and the next carry eff - c * b. Returns (packed (R, d_pad/8) uint8,
    new_residual (R, d_pad) f32); b as in :func:`stoch_quant_pack`."""
    m, d_pad, per = _check_args(delta, b, u, residual)
    if delta.device.type == "cpu":
        return ref.stoch_quant_compress_ref(delta, b, u, residual, want_residual=True)
    out = torch.empty((m, d_pad // 8), dtype=torch.uint8, device=delta.device)
    new_res = torch.empty_like(delta)
    lib = _build.library("stoch_quant")
    rc = lib.probit_stoch_quant_ef(
        delta.data_ptr(), residual.data_ptr(), b.data_ptr(), u.data_ptr(),
        out.data_ptr(), new_res.data_ptr(), m, d_pad, per,
        torch.cuda.current_stream(delta.device).cuda_stream,
    )
    _build.check(rc, "stoch_quant_ef")
    return out, new_res
