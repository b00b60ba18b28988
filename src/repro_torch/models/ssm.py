"""Mamba-1 selective-SSM mixer: the chunked prefill and the O(1) decode step.

Counterpart of ``repro/models/ssm.py``. The sequence is cut into chunks: a
Python loop over chunks (the reference's ``lax.scan``) carries the SSM
state ``h0`` from chunk to chunk, and within a chunk :func:`associative_scan`
runs on the time axis in log depth, the odd/even recursion of
``jax.lax.associative_scan`` in its combine order (about 2n combines, where
a Hillis-Steele scan does n log n). The dtypes are the reference's: the
projections in the parameters' dtype, ``dt``, ``B`` and ``C`` widened to f32
and ``a = -exp(a_log)`` in f32; the decays and drives, and so the scan, in
the :func:`ssm_state_dtype` (f32 by default). XLA contracts the
combine's ``a2 * b1 + b2`` into a fused multiply-add, and so does the
port (``torch.addcmul``): on the CPU the scan equals the jitted
reference's bit for bit. SiLU and softplus are XLA's expansions of them, a
rounding a step, with JAX's derivatives. The decode step
(:func:`mamba_decode_step`) carries the last ``d_conv - 1`` inputs of the
convolution (bf16) and the SSM state (f32) in its cache
(:func:`init_mamba_cache`).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from .. import distributed
from ..distributed import einsum, shard
from .config import ModelConfig
from .layers import causal_conv1d
from .spec import LeafSpec

__all__ = ["ssm_state_dtype", "mamba_specs", "associative_scan", "mamba_block", "init_mamba_cache",
           "mamba_cache_logical",
           "mamba_decode_step"]

# Dtype of the chunked scan's state tensors (decays, drives, h): f32 by
# default; bf16 halves their traffic (the decays are in (0, 1]).
_SSM_STATE_DTYPE: contextvars.ContextVar[str] = contextvars.ContextVar("repro_torch_ssm_state_dtype",
                                                                       default="float32")


@contextlib.contextmanager
def ssm_state_dtype(name: str):
    tok = _SSM_STATE_DTYPE.set(name)
    try:
        yield
    finally:
        _SSM_STATE_DTYPE.reset(tok)


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_in = cfg.expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)
    return d_in, dt_rank, cfg.d_state


def mamba_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, dt_rank, ds = _dims(cfg)
    return {
        "in_proj": LeafSpec((d, 2 * d_in), (None, "ff")),
        "conv_w": LeafSpec((cfg.d_conv, d_in), (None, "ff"), scale=0.5),
        "conv_b": LeafSpec((d_in,), ("ff",), "zeros"),
        "x_proj": LeafSpec((d_in, dt_rank + 2 * ds), ("ff", None)),
        "dt_proj": LeafSpec((dt_rank, d_in), (None, "ff")),
        "dt_bias": LeafSpec((d_in,), ("ff",), "zeros"),
        "a_log": LeafSpec((d_in, ds), ("ff", None), "ones"),
        "d_skip": LeafSpec((d_in,), ("ff",), "ones"),
        "out_proj": LeafSpec((d_in, d), ("ff", None)),
    }


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` as XLA expands it, ``1 / (1 + exp(-x))`` with each
    step rounded to ``x``'s dtype (bf16 included: ``F.sigmoid`` rounds once
    and differs in ~30% of bf16 values), and its JVP ``g * (s * (1 - s))``."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``, ``logaddexp(x, 0)``, as XLA expands it:
    ``max(x, 0) + log1p(exp(-|x|))`` with each step rounded to ``x``'s
    dtype, and its JVP ``g * exp(x - out)``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * _Logistic.apply(x)


def _ssm_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (u, z), each (B, S, d_in) in the parameters' dtype."""
    d_in, _, _ = _dims(cfg)
    xz = shard(einsum("bsd,de->bse", x, p["in_proj"]), "batch", None, "ff")
    return xz[..., :d_in], xz[..., d_in:]


def _ssm_params(p: dict, u: torch.Tensor, cfg: ModelConfig):
    """(dt (B, S, d_in), B (B, S, ds), C (B, S, ds), a (d_in, ds)), f32:
    ``dt``'s softplus in the parameters' dtype, then widened."""
    _, dt_rank, ds = _dims(cfg)
    dbc = einsum("bse,ef->bsf", u, p["x_proj"])
    dt, bc, cc = dbc[..., :dt_rank], dbc[..., dt_rank : dt_rank + ds], dbc[..., dt_rank + ds :]
    dt = _Softplus.apply(einsum("bsr,re->bse", dt, p["dt_proj"]) + p["dt_bias"]).float()
    a = -torch.exp(p["a_log"].float())
    return dt, bc.float(), cc.float(), a


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """``even[0], odd[0], even[1], odd[1], ...`` along ``dim``; ``even`` is
    as long as ``odd`` or one longer."""
    n = odd.shape[dim]
    pairs = torch.stack([even.narrow(dim, 0, n), odd], dim=dim + 1).flatten(dim, dim + 1)
    if even.shape[dim] == n:
        return pairs
    return torch.cat([pairs, even.narrow(dim, n, 1)], dim=dim)


def associative_scan(combine, elems: tuple, dim: int = 1) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``combine(earlier, later)``, in ``jax.lax.associative_scan``'s
    order: combine adjacent pairs, scan the half-length sequence (whose
    results are the odd positions), then combine each of them with the next
    even element; position 0 passes through. Odd lengths leave the last
    element out of the pairing, as JAX does."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def every_other(e, start, stop=None):
        return e.narrow(dim, start, (stop if stop is not None else e.shape[dim]) - start)[
            (slice(None),) * dim + (slice(None, None, 2),)]

    reduced = combine(tuple(every_other(e, 0, n - 1) for e in elems), tuple(every_other(e, 1) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    head = tuple(o.narrow(dim, 0, o.shape[dim] - 1) for o in odd) if n % 2 == 0 else odd
    even = combine(head, tuple(every_other(e, 2) for e in elems))
    even = tuple(torch.cat([e.narrow(dim, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _combine(e1, e2):
    """``(a2 * a1, a2 * b1 + b2)``; the multiply-add fused, as XLA
    contracts it (``addcmul`` rounds once)."""
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, torch.addcmul(b2, a2, b1)


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, chunk: int = 256) -> torch.Tensor:
    """Full-sequence forward. x: (B, S, d)."""
    b, s, _ = x.shape
    d_in, _, ds = _dims(cfg)
    u, z = _ssm_inputs(p, x, cfg)
    u = _silu(causal_conv1d(u, p["conv_w"], p["conv_b"]))
    dt, bc, cc, a = _ssm_params(p, u, cfg)
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a whole number of Mamba chunks of {c}")
    sdt = getattr(torch, _SSM_STATE_DTYPE.get())

    def scan(dt, bc, cc, a, uf, d_skip):
        # on a mesh: this rank's batch and d_inner shards (the channels scan
        # independently)
        h0 = torch.zeros((dt.shape[0], dt.shape[2], ds), dtype=torch.float32, device=dt.device)
        ys = []
        for t0 in range(0, s, c):
            sl = slice(t0, t0 + c)
            dt_c = dt[:, sl, :, None]
            adt = torch.exp(dt_c * a).to(sdt)  # (B, c, d_in, ds)
            drive = (dt_c * uf[:, sl, :, None] * bc[:, sl, None, :]).to(sdt)
            a_cum, b_cum = associative_scan(_combine, (adt, drive), dim=1)
            h = torch.addcmul(b_cum, a_cum, h0[:, None].to(sdt))
            ys.append(torch.einsum("bcds,bcs->bcd", h.float(), cc[:, sl]))
            h0 = h[:, -1].float()
        return torch.cat(ys, dim=1) + uf * d_skip.float()

    act, state = ("batch", None, "ff"), ("batch", None, None)
    y = distributed.logical_region(scan, (dt, bc, cc, a, u.float(), p["d_skip"]),
                                   (act, state, state, ("ff", None), act, ("ff",)), (act, dt.shape), params=(3, 5))
    y = y.to(x.dtype) * _silu(z)
    return shard(einsum("bse,ed->bsd", y, p["out_proj"]), "batch", None, None)


# -- decode -------------------------------------------------------------------

def init_mamba_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    d_in, _, ds = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, d_in), dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros((batch, d_in, ds), dtype=torch.float32, device=device)}


def mamba_cache_logical() -> dict:
    return {"conv": ("batch", None, "ff"), "ssm": ("batch", "ff", None)}


def mamba_decode_step(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d); O(1) state update. Returns the output and a new cache.
    The state update ``adt * h + drive`` is one fused multiply-add, as XLA
    contracts it."""
    u, z = _ssm_inputs(p, x, cfg)  # (B, 1, d_in)
    conv_in = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
    u1 = _silu(causal_conv1d(conv_in, p["conv_w"], p["conv_b"])[:, -1:, :])
    dt, bc, cc, a = _ssm_params(p, u1, cfg)
    dt0 = dt[:, 0, :, None]
    adt = torch.exp(dt0 * a)  # (B, d_in, ds)
    drive = dt0 * u1.float()[:, 0, :, None] * bc[:, 0, None, :]
    h = torch.addcmul(drive, adt, cache["ssm"])
    y = torch.einsum("bds,bs->bd", h, cc[:, 0])[:, None, :]
    y = y + u1.float() * p["d_skip"].float()
    y = y.to(x.dtype) * _silu(z)
    out = shard(einsum("bse,ed->bsd", y, p["out_proj"]), "batch", None, None)
    return out, {"conv": conv_in[:, 1:, :].to(torch.bfloat16), "ssm": h}
