"""Binding of the vote-count + Eq.-13 estimate kernel (B3).

``bit_aggregate`` replaces the Pallas ``bit_aggregate_2d``
(``repro/kernels/bit_aggregate.py``); the CUDA source is
``csrc/bit_aggregate.cu``. Any ``P`` bytes a row and any ``M`` clients:
the TPU kernel's 128-byte lane and 8-row client tiles are gone.

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.bit_aggregate_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, ref

__all__ = ["bit_aggregate"]


def bit_aggregate(packed: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """packed (M, P) uint8, b (8P,) f32 -> theta_hat (8P,) f32."""
    m, p = packed.shape
    if packed.dtype != torch.uint8 or not packed.is_contiguous():
        raise ValueError(f"packed: need contiguous uint8 (M, P), got {packed.dtype}")
    if b.shape != (8 * p,) or b.dtype != torch.float32 or not b.is_contiguous():
        raise ValueError(f"b: need contiguous f32 ({8 * p},), got {b.dtype} {tuple(b.shape)}")
    if b.device != packed.device:
        raise ValueError(f"b is on {b.device}, packed on {packed.device}")
    if m < 1 or m >= 2**24:
        raise ValueError(f"client count must be in [1, 2**24), got {m}")
    if packed.device.type == "cpu":
        return ref.bit_aggregate_ref(packed, b)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    out = torch.empty((8 * p,), dtype=torch.float32, device=packed.device)
    recip = float(np.float32(1.0) / np.float32(m))
    lib = _build.library("bit_aggregate")
    rc = lib.probit_bit_aggregate(
        packed.data_ptr(), b.data_ptr(), out.data_ptr(), m, p, recip,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _build.check(rc, "bit_aggregate")
    return out
