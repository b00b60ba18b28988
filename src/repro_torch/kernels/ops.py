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

Wire format: the kernel wire is ``padded_len(d)/8`` bytes a row
(1024-coordinate rows, the reference's TPU tile, kept because it defines
the wire). Pad coordinates carry delta = -1, b = 1, u = 1.0, so pad bits
are 0. Both engines emit this width; the ``ref`` engine realigns the
chunked packer's ``padded_dim(d)/8`` row losslessly, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.quantizer import PACK_CHUNK, cohort_uniforms, packed_binarize_batch, pad_rows
from . import ref

__all__ = [
    "ENGINES",
    "LANES",
    "resolve_engine",
    "padded_len",
    "realign_wire",
    "stoch_quant_compress_batch",
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
    """Cut or zero-pad packed rows to ``target`` bytes (pad bits are 0)."""
    width = packed.shape[1]
    if width > target:
        return packed[:, :target].contiguous()
    if width < target:
        return F.pad(packed, (0, target - width))
    return packed


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
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Eq.-5 compress of an (M, d) cohort onto the kernel wire.

    Client ``i`` draws from ``fold_in(key, row_offset + i)`` on the
    ``client_uniforms`` chunk schedule, so both engines emit the JAX
    wire's bytes. The kernel engine draws the uniforms in blocks of client
    rows (``cohort_uniforms``) into one padded (M, padded_len) buffer and
    launches one kernel over the whole cohort; the ``ref`` engine
    compresses block by block (``packed_binarize_batch``). ``residual``
    is the error-feedback carry added to the deltas first (fused into the
    kernel); with ``want_residual`` the next carry ``eff - c * b`` comes
    back. ``b`` is the (d,) public range.

    Returns (packed (M, padded_len(d)/8) uint8, residuals (M, d) or None).
    """
    engine = resolve_engine(engine, deltas.device)
    m, d = deltas.shape
    target = padded_len(d) // 8
    if engine == "ref":
        eff = deltas if residual is None else deltas + residual
        packed, res = packed_binarize_batch(
            key, eff, b, chunk=chunk, want_residual=want_residual, row_offset=row_offset
        )
        return realign_wire(packed, target), res
    from .stoch_quant import stoch_quant_ef, stoch_quant_pack

    width = 8 * target
    u = torch.empty((m, width), dtype=torch.float32, device=deltas.device)
    u[:, d:] = 1.0
    cohort_uniforms(key, m, d, chunk, row_offset=row_offset, out=u)
    d_p = pad_rows(deltas, width, -1.0)
    b_p = F.pad(torch.broadcast_to(b.float(), (d,)), (0, width - d), value=1.0)
    if residual is None and not want_residual:
        return stoch_quant_pack(d_p, b_p, u), None
    r_p = torch.zeros_like(d_p) if residual is None else pad_rows(residual, width, 0.0)
    packed, res = stoch_quant_ef(d_p, r_p, b_p, u)
    return packed, (res[:, :d] if want_residual else None)


def bit_aggregate(packed: torch.Tensor, b: torch.Tensor, n: int, *, engine: str | None = None) -> torch.Tensor:
    """packed (M, P) uint8, b (n,) or a scalar -> theta_hat (n,) f32 (Eq. 13).

    Pad coordinates (>= n) never reach the estimate: both engines take b at
    its true length n.
    """
    engine = resolve_engine(engine, packed.device)
    b_full = torch.broadcast_to(b.float(), (n,))
    if engine == "ref":
        return ref.bit_aggregate_ref(packed, b_full)
    from .bit_aggregate import bit_aggregate as kernel

    return kernel(packed.contiguous(), b_full.contiguous())


def prox_sgd(w, w0, grad, momentum, eta: float, lam: float, mu: float, *, out=None,
             engine: str | None = None):
    """Fused prox-SGD step on an (M, d) cohort (or one (d,) row); ``w0``
    may be one shared (d,) row. Returns (w_new, momentum_new), written into
    ``out=(w_out, m_out)`` when it is given: contiguous buffers of ``w``'s
    shape, where ``w_out`` may be ``w`` and ``m_out`` ``momentum`` (an update
    in place). Both engines take the same ``out``."""
    engine = resolve_engine(engine, w.device)
    if engine == "ref":
        if out is not None:
            from .prox_sgd import check_out

            out = check_out(out, w, w0, grad, momentum)
        return ref.prox_sgd_ref(w, w0, grad, momentum, eta, lam, mu, out=out)
    from .prox_sgd import prox_sgd as kernel

    return kernel(w.contiguous(), w0.contiguous(), grad.contiguous(), momentum.contiguous(), eta, lam, mu,
                  out=out)
