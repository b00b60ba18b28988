"""Binding of the fused prox-SGD + momentum kernel (B4).

``prox_sgd`` replaces the Pallas ``prox_sgd_2d``
(``repro/kernels/prox_sgd.py``); the CUDA source is ``csrc/prox_sgd.cu``.
One launch updates all rows of a group of E elements (a campaign group's
(cell, seed) runs; one run's ``(M, d)`` cohort is E = 1): each element has
its own global model, a row of ``w0`` (E, d), and its own ``(eta, lam,
mu)``, a row of the f32 ``coeffs`` (E, 3) that the kernel reads from
device memory (:func:`repro_torch.kernels.ops.prox_coeffs` makes it).
``out=(w_out, m_out)`` receives the result, ``w_out`` and ``m_out`` may be
``w`` and ``momentum`` themselves (an update in place).

The launch covers (column tiles x row groups of each element), one CTA a
unit:
:func:`launch_geometry` picks the tile, the group and the grid, and the C
entry launches what it is given. On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.prox_sgd_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

__all__ = ["TILE", "ROWS", "W0_L2_BYTES", "launch_geometry", "occupancy", "check_out", "prox_sgd"]

TILE = 2048  # columns of a unit: the w0 slice a CTA keeps in shared memory (8 KB)
ROWS = 2  # rows of a unit when w0 does not stay in L2
W0_L2_BYTES = 12_500_000  # a w0 row up to a quarter of the H100's 50 MB L2 stays there


@functools.lru_cache(maxsize=None)
def launch_geometry(m: int, d: int, sms: int, blocks_per_sm: int, elements: int = 1) -> tuple[int, int, int]:
    """(tile columns, rows per group, CTAs) of the launch for ``elements``
    elements of ``m`` rows of ``d`` columns each (an ``(m, d)`` cohort is
    one element) on a card with ``sms`` SMs that holds ``blocks_per_sm`` of
    the kernel's CTAs on each.

    A unit is ``TILE`` columns of ``rows`` client rows of one element, and
    each unit gets a CTA of its own; its CTA reads its element's w0 slice of
    those columns once. While w0 (``4 d`` bytes a row) stays in L2 a unit
    is one row, and w0 is re-read from L2 for every row; a larger w0 is read
    from device memory once per group of ``ROWS`` rows. A launch whose units
    would not fill one wave of the ``sms * blocks_per_sm`` CTA slots takes
    one-row units too.

    Measured on the H100 at 700 W (``chip_smoke.py`` phase 5, ``b4_sweep``;
    ``PERF.md``): at M = 100 and ResNet-18's d = 11,172,042, units of 4,096
    elements (2,048 x 2 or 1,024 x 4) were the fastest; 100-row units (w0
    read once) ran ~18% slower, one-row units ~7% (w0 re-read from device
    memory for every row), 4-row units ~1%, and a persistent grid of one wave
    walking the same units ~5%. At the MLP's d = 118,282 one-row units were
    the fastest (4 rows ~8% slower, 100 rows ~40%), and where w0 stays in L2
    (up to d = 1,117,204 measured) one-row units reach 88-90% of the bound.
    """
    tiles = -(-d // TILE)
    rows = 1 if 4 * d <= W0_L2_BYTES else min(ROWS, m)
    if tiles * elements * -(-m // rows) < sms * blocks_per_sm:
        rows = 1
    return TILE, rows, tiles * elements * -(-m // rows)


@functools.lru_cache(maxsize=None)
def occupancy(device_index: int, shared_w0: bool) -> tuple[int, int]:
    """(SMs, resident CTAs per SM) of the kernel on a CUDA device, as the
    CUDA runtime reports them for a ``TILE``-column unit."""
    out = (ctypes.c_int64 * 2)()
    with torch.cuda.device(device_index):
        rc = _build.library("prox_sgd").probit_prox_sgd_occupancy(TILE, int(shared_w0), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"prox_sgd occupancy query failed: cudaError_t {rc}")
    return out[0], out[1]


def _span(t: torch.Tensor) -> tuple[int, int]:
    """The byte range ``t``'s elements lie in (an expanded view's is its
    base row's, not ``numel`` elements)."""
    extent = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride())) if t.numel() else 0
    return t.data_ptr(), t.data_ptr() + extent * t.element_size()


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def check_out(out, w, w0, grad, momentum) -> tuple[torch.Tensor, torch.Tensor]:
    """Validate ``out=(w_out, m_out)``: contiguous f32 of ``w``'s shape on its
    device; ``w_out`` is ``w`` or overlaps no operand, ``m_out`` is
    ``momentum`` or overlaps no operand, and the two do not overlap."""
    w_out, m_out = out
    for name, t in (("w_out", w_out), ("m_out", m_out)):
        if (t.shape != w.shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != w.device):
            raise ValueError(f"{name}: need contiguous f32 {tuple(w.shape)} on {w.device}")
    if _overlap(w_out, m_out):
        raise ValueError("w_out and m_out overlap")
    for name, t, alias in (("w_out", w_out, "w"), ("m_out", m_out, "momentum")):
        allowed = _span(w if alias == "w" else momentum)
        for operand in (w, w0, grad, momentum):
            if _overlap(t, operand) and not _span(t) == _span(operand) == allowed:
                raise ValueError(f"{name} may alias only {alias}")
    return w_out, m_out


def prox_sgd(w, w0, grad, momentum, coeffs, *, out=None):
    """w, grad, momentum (R, d) or (d,) f32: the rows of E elements of R/E
    rows each; w0 (E, d) f32, the global model of each element ((d,) for
    E = 1; (R, d) gives every row its own); coeffs (E, 3) f32, each
    element's ``(eta, lam, mu)``, or (1, 3) for all, on w's device.
    Returns (w_new, momentum_new), written into ``out`` when it is given."""
    d = w.shape[-1]
    for name, t in (("w", w), ("grad", grad), ("momentum", momentum), ("w0", w0), ("coeffs", coeffs)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != w.device:
            raise ValueError(f"{name}: need contiguous f32 on {w.device}")
    if grad.shape != w.shape or momentum.shape != w.shape:
        raise ValueError("grad and momentum must match w's shape")
    if w0.dim() not in (1, 2) or w0.shape[-1] != d:
        raise ValueError(f"w0 must be ({d},) or (E, {d}), got {tuple(w0.shape)}")
    rows = w.numel() // d
    elements = w0.numel() // d
    per = ref.element_rows(rows, elements)
    if coeffs.dim() != 2 or coeffs.shape[1] != 3 or coeffs.shape[0] not in (1, elements):
        raise ValueError(f"coeffs must be (1, 3) or ({elements}, 3), got {tuple(coeffs.shape)}")
    if out is not None:
        out = check_out(out, w, w0, grad, momentum)
    if w.device.type == "cpu":
        return ref.prox_sgd_ref(w, w0, grad, momentum, coeffs, out=out)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    w_out, m_out = out if out is not None else (torch.empty_like(w), torch.empty_like(w))
    shared = per > 1
    tile, group_rows, ctas = launch_geometry(per, d, *occupancy(w.device.index or 0, shared), elements)
    streams = (w, grad, momentum, w_out, m_out) + (() if shared else (w0,))
    vector = len({t.data_ptr() % 16 for t in streams}) == 1
    lib = _build.library("prox_sgd")
    rc = lib.probit_prox_sgd(
        w.data_ptr(), w0.data_ptr(), grad.data_ptr(), momentum.data_ptr(), w_out.data_ptr(), m_out.data_ptr(),
        coeffs.data_ptr(), 3 if coeffs.shape[0] > 1 else 0, rows, d, per, tile, group_rows, ctas, int(vector),
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    _build.check(rc, "prox_sgd")
    return w_out, m_out
