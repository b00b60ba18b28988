"""Binding of the fused prox-SGD + momentum kernel (B4).

``prox_sgd`` replaces the Pallas ``prox_sgd_2d``
(``repro/kernels/prox_sgd.py``); the CUDA source is ``csrc/prox_sgd.cu``.
One launch updates the whole ``(M, d)`` cohort; the global model ``w0`` may
be one shared ``(d,)`` row.

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.prox_sgd_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["prox_sgd"]


def prox_sgd(w, w0, grad, momentum, eta: float, lam: float, mu: float):
    """w, grad, momentum (M, d) or (d,) f32; w0 the same shape or (d,).
    Returns (w_new, momentum_new)."""
    d = w.shape[-1]
    for name, t in (("w", w), ("grad", grad), ("momentum", momentum), ("w0", w0)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != w.device:
            raise ValueError(f"{name}: need contiguous f32 on {w.device}")
    if grad.shape != w.shape or momentum.shape != w.shape:
        raise ValueError("grad and momentum must match w's shape")
    if w0.shape == w.shape:
        w0_stride = d
    elif w0.shape == (d,):
        w0_stride = 0
    else:
        raise ValueError(f"w0 must be {tuple(w.shape)} or ({d},), got {tuple(w0.shape)}")
    if w.device.type == "cpu":
        return ref.prox_sgd_ref(w, w0, grad, momentum, eta, lam, mu)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    w_out = torch.empty_like(w)
    m_out = torch.empty_like(w)
    lib = _build.library("prox_sgd")
    rc = lib.probit_prox_sgd(
        w.data_ptr(), w0.data_ptr(), grad.data_ptr(), momentum.data_ptr(),
        w_out.data_ptr(), m_out.data_ptr(), eta, lam, mu, w.numel() // d, d, w0_stride,
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    _build.check(rc, "prox_sgd")
    return w_out, m_out
