"""xLSTM mixers [arXiv:2405.04517]: mLSTM (matrix memory, chunked-parallel)
and sLSTM (scalar memory, strictly sequential exponential gating).

Counterpart of ``repro/models/xlstm.py``. The mLSTM cell
runs in chunkwise-parallel form: within a chunk every timestep is computed
with dense einsums, and a Python loop over chunks (the reference's
``lax.scan``) carries the stabilized matrix state (C_hat, n_hat, m). The
sLSTM cell has a true sequential dependency, so it is a Python loop over
time where the reference scans. Both keep the reference's dtypes: the
projections in the parameters' dtype, the cells in f32 (a bf16 operand
of an f32 product is widened first, as JAX promotes it; ``torch.einsum``
refuses mixed dtypes). Maxima are ``amax`` and ``torch.cummax``, whose
gradients go to the maxima as JAX's do. Each mixer has an O(1) decode
step over its cache: the mLSTM's matrix state, normalizer, stabilizer and
the convolution's last inputs (bf16); the sLSTM's four (B, H, hd) f32
states. Both caches start the stabilizer at ``M_INIT``: the first step's
decay ``exp(M_INIT + ...)`` is 0, not a NaN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import distributed
from ..distributed import einsum, shard
from .config import ModelConfig
from .layers import causal_conv1d
from .spec import LeafSpec

__all__ = ["mlstm_specs", "mlstm_block", "init_mlstm_cache", "mlstm_cache_logical", "mlstm_decode_step",
           "slstm_specs", "slstm_block", "init_slstm_cache", "slstm_cache_logical", "slstm_decode_step"]

# The stabilizer's start: exp of anything offset by it underflows to 0.
M_INIT = -1e30


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    dup = int(cfg.proj_factor * cfg.d_model)
    return dup, dup // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dup, _ = _mlstm_dims(cfg)
    h = cfg.n_heads
    return {
        "w_up": LeafSpec((d, 2 * dup), (None, "ff")),
        "conv_w": LeafSpec((cfg.d_conv, dup), (None, "ff"), scale=0.5),
        "conv_b": LeafSpec((dup,), ("ff",), "zeros"),
        "wq": LeafSpec((dup, dup), (None, "ff")),
        "wk": LeafSpec((dup, dup), (None, "ff")),
        "wv": LeafSpec((dup, dup), (None, "ff")),
        "wi": LeafSpec((dup, h), (None, None), scale=0.01),
        "bi": LeafSpec((h,), (None,), "zeros"),
        "wf": LeafSpec((dup, h), (None, None), scale=0.01),
        "bf": LeafSpec((h,), (None,), "ones"),  # bias toward remembering
        "w_down": LeafSpec((dup, d), ("ff", None)),
    }


def _mlstm_qkvg(p: dict, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    dup, hd = _mlstm_dims(cfg)
    h = cfg.n_heads
    ug = shard(einsum("bsd,de->bse", x, p["w_up"]), "batch", None, "ff")
    u, g = ug[..., :dup], ug[..., dup:]
    u = F.silu(causal_conv1d(u, p["conv_w"], p["conv_b"]))
    q = einsum("bse,ef->bsf", u, p["wq"]).reshape(b, s, h, hd)
    k = einsum("bse,ef->bsf", u, p["wk"]).reshape(b, s, h, hd) * hd**-0.5
    v = einsum("bse,ef->bsf", u, p["wv"]).reshape(b, s, h, hd)
    li = (einsum("bse,eh->bsh", u, p["wi"]) + p["bi"]).float()
    lf = distributed.pointwise(F.logsigmoid, (einsum("bse,eh->bsh", u, p["wf"]) + p["bf"]).float())
    return q, k, v, li, lf, g


def _mlstm_chunk(carry, q, k, v, li, lf):
    """One chunk of the stabilized chunkwise-parallel mLSTM cell.

    carry: C_hat (B,H,hd,hd), n_hat (B,H,hd), m (B,H)
    q, k, v (B,c,H,hd); li, lf (B,c,H)
    """
    c_hat, n_hat, m = carry
    qf, kf, vf = q.float(), k.float(), v.float()
    bcum = torch.cumsum(lf, dim=1)  # (B,c,H) inclusive decay from chunk start
    btot = bcum[:, -1]  # (B,H)
    s_t = li - bcum  # log weight of step t relative to chunk end (+btot)

    # ---- state update (to chunk end) ----
    m_new = torch.maximum(m + btot, btot + s_t.amax(1))
    w_end = torch.exp(btot[:, None] + s_t - m_new[:, None])  # (B,c,H)
    decay_old = torch.exp(m + btot - m_new)  # (B,H)
    c_new = decay_old[..., None, None] * c_hat + torch.einsum("bch,bchk,bchv->bhkv", w_end, kf, vf)
    n_new = decay_old[..., None] * n_hat + torch.einsum("bch,bchk->bhk", w_end, kf)

    # ---- outputs within chunk ----
    run_max = torch.cummax(s_t, dim=1).values  # (B,c,H): max_{s<=t} s_s
    m_t = torch.maximum(m[:, None] + bcum, bcum + run_max)  # (B,c,H)
    inter_scale = torch.exp(m[:, None] + bcum - m_t)  # (B,c,H)
    inter_y = torch.einsum("bchk,bhkv->bchv", qf, c_hat) * inter_scale[..., None]
    inter_n = torch.einsum("bchk,bhk->bch", qf, n_hat) * inter_scale

    # intra-chunk: D[t,s] = exp(b_t + s_s - m_t) for s <= t. The exponent is
    # masked before the exp, where the reference masks after it: above the
    # diagonal it reaches ~108 at full width, exp overflows, and the
    # reference's backward multiplies the masked zero by inf (NaN in every
    # mLSTM gradient; ROADMAP C). The same bits forward; the same gradient
    # wherever the reference's is finite.
    cl = q.shape[1]
    logd = bcum[:, :, None, :] + s_t[:, None, :, :] - m_t[:, :, None, :]
    causal = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=q.device))
    dmat = torch.exp(torch.where(causal[None, :, :, None], logd, torch.full((), -torch.inf, device=q.device)))
    qk = torch.einsum("bchk,bshk->bcsh", qf, kf)  # (B,c,c,H)
    intra_y = torch.einsum("bcsh,bcsh,bshv->bchv", qk, dmat, vf)
    intra_n = torch.einsum("bcsh,bcsh->bch", qk, dmat)

    denom = torch.maximum((inter_n + intra_n).abs(), torch.exp(-m_t))
    h_out = (inter_y + intra_y) / denom[..., None]
    return (c_new, n_new, m_new), h_out.to(q.dtype)


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, chunk: int = 256) -> torch.Tensor:
    b, s, _ = x.shape
    dup, hd = _mlstm_dims(cfg)
    h = cfg.n_heads
    q, k, v, li, lf, g = _mlstm_qkvg(p, x, cfg)
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a whole number of mLSTM chunks of {c}")

    def cell(q, k, v, li, lf):
        # on a mesh: this rank's batch and head shards (the heads run apart)
        bl, hl, dev = q.shape[0], q.shape[2], q.device
        carry = (
            torch.zeros((bl, hl, hd, hd), dtype=torch.float32, device=dev),
            torch.zeros((bl, hl, hd), dtype=torch.float32, device=dev),
            torch.full((bl, hl), M_INIT, dtype=torch.float32, device=dev),
        )
        hs = []
        for t0 in range(0, s, c):
            sl = slice(t0, t0 + c)
            carry, h_out = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl])
            hs.append(h_out)
        return torch.cat(hs, dim=1)

    heads4, heads3 = ("batch", None, "heads", None), ("batch", None, "heads")
    hseq = distributed.logical_region(cell, (q, k, v, li, lf), (heads4, heads4, heads4, heads3, heads3),
                                      (heads4, q.shape)).reshape(b, s, dup)
    return shard(einsum("bse,ed->bsd", hseq * F.silu(g), p["w_down"]), "batch", None, None)


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    dup, hd = _mlstm_dims(cfg)
    h = cfg.n_heads
    return {
        "c": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), M_INIT, dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, dup), dtype=torch.bfloat16, device=device),
    }


def mlstm_cache_logical() -> dict:
    return {
        "c": ("batch", None, "ff", None),
        "n": ("batch", None, "ff"),
        "m": ("batch", None),
        "conv": ("batch", None, "ff"),
    }


def mlstm_decode_step(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d); the sequential mLSTM cell. Returns the output and a new
    cache."""
    b = x.shape[0]
    dup, hd = _mlstm_dims(cfg)
    h = cfg.n_heads
    ug = shard(einsum("bsd,de->bse", x, p["w_up"]), "batch", None, "ff")
    u, g = ug[..., :dup], ug[..., dup:]
    conv_in = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
    u1 = F.silu(causal_conv1d(conv_in, p["conv_w"], p["conv_b"])[:, -1:, :])
    q = einsum("bse,ef->bsf", u1, p["wq"]).reshape(b, h, hd).float()
    k = (einsum("bse,ef->bsf", u1, p["wk"]).reshape(b, h, hd) * hd**-0.5).float()
    v = einsum("bse,ef->bsf", u1, p["wv"]).reshape(b, h, hd).float()
    li = (einsum("be,eh->bh", u1[:, 0], p["wi"]) + p["bi"]).float()
    lf = distributed.pointwise(F.logsigmoid, (einsum("be,eh->bh", u1[:, 0], p["wf"]) + p["bf"]).float())

    def cell(q, k, v, li, lf, c, n, m):
        # on a mesh: this rank's batch shard, every head
        m_new = torch.maximum(m + lf, li)
        decay = torch.exp(m + lf - m_new)
        inj = torch.exp(li - m_new)
        c_new = decay[..., None, None] * c + inj[..., None, None] * (k[..., :, None] * v[..., None, :])
        n_new = decay[..., None] * n + inj[..., None] * k
        y = torch.einsum("bhk,bhkv->bhv", q, c_new)
        denom = torch.maximum(torch.einsum("bhk,bhk->bh", q, n_new).abs(), torch.exp(-m_new))
        return y / denom[..., None], c_new, n_new, m_new

    b2, b3, b4 = ("batch", None), ("batch", None, None), ("batch", None, None, None)
    hv, c_new, n_new, m_new = distributed.logical_region(
        cell, (q, k, v, li, lf, cache["c"], cache["n"], cache["m"]), (b3, b3, b3, b2, b2, b4, b3, b2),
        [(b3, q.shape), (b4, cache["c"].shape), (b3, cache["n"].shape), (b2, cache["m"].shape)])
    hvec = hv.reshape(b, 1, dup).to(x.dtype)
    out = shard(einsum("bse,ed->bsd", hvec * F.silu(g), p["w_down"]), "batch", None, None)
    return out, {"c": c_new, "n": n_new, "m": m_new, "conv": conv_in[:, 1:, :].to(torch.bfloat16)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    return {
        "w_in": LeafSpec((d, 4 * d), (None, "ff")),  # i,f,z,o stacked
        "b_in": LeafSpec((4 * d,), ("ff",), "zeros"),
        "r": LeafSpec((4, h, hd, hd), (None, None, None, None), scale=0.01),
        "out_proj": LeafSpec((d, d), (None, None)),
    }


def _slstm_cell(carry, gates, r, n_floor):
    """carry: (c, n, m, h) each (B,H,hd) f32; gates: (B,4,H,hd)
    pre-activation from the input projection; r: (4,H,hd,hd) recurrent
    weights widened to f32 (JAX promotes the bf16 operand); ``n_floor``
    the 0-dim f32 1e-6 the normalizer is held above (``maximum``, whose
    gradient splits a tie as JAX's does)."""
    c, n, m, h = carry
    rec = torch.einsum("bhe,ghek->bghk", h, r)  # (B,4,H,hd) f32
    gi, gf, gz, go = (gates + rec).unbind(1)  # bf16 + f32 -> f32
    lf = F.logsigmoid(gf)
    m_new = torch.maximum(lf + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(lf + m - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.maximum(n_new, n_floor)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    gates = (einsum("bsd,dg->bsg", x, p["w_in"]) + p["b_in"]).reshape(b, s, 4, h, hd)

    def steps(gates, r):
        # on a mesh: this rank's batch and head shards
        bl, hl, dev = gates.shape[0], gates.shape[3], gates.device
        z = torch.zeros((bl, hl, hd), dtype=torch.float32, device=dev)
        carry = (z, z, torch.full((bl, hl, hd), M_INIT, dtype=torch.float32, device=dev), z)
        r, n_floor = r.float(), torch.tensor(1e-6, device=dev)
        hs = []
        for t in range(s):
            carry, h_t = _slstm_cell(carry, gates[:, t], r, n_floor)
            hs.append(h_t)
        return torch.stack(hs, dim=1)

    hs_logical = ("batch", None, "heads", None)
    hseq = distributed.logical_region(steps, (gates, p["r"]), (("batch", None, None, "heads", None),
                                                               (None, "heads", None, None)),
                                      (hs_logical, (b, s, h, hd)), params=(1,))
    hseq = hseq.reshape(b, s, d).to(x.dtype)
    return shard(einsum("bsd,de->bse", hseq, p["out_proj"]), "batch", None, None)


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {"c": torch.zeros(shape, dtype=torch.float32, device=device),
            "n": torch.zeros(shape, dtype=torch.float32, device=device),
            "m": torch.full(shape, M_INIT, dtype=torch.float32, device=device),
            "h": torch.zeros(shape, dtype=torch.float32, device=device)}


def slstm_cache_logical() -> dict:
    return {k: ("batch", None, None) for k in ("c", "n", "m", "h")}


def slstm_decode_step(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d); one step of :func:`_slstm_cell`. Returns the output
    and a new cache."""
    b, _, d = x.shape
    h = cfg.n_heads
    gates = (einsum("bsd,dg->bsg", x, p["w_in"]) + p["b_in"]).reshape(b, 4, h, d // h)

    def step(gates, r, c, n, m, hh):
        # on a mesh: this rank's batch shard, every head
        (c, n, m, hh), h_new = _slstm_cell((c, n, m, hh), gates, r.float(), torch.tensor(1e-6, device=gates.device))
        return c, n, m, hh, h_new

    b3, b4 = ("batch", None, None), ("batch", None, None, None)
    c, n, m, hh, h_new = distributed.logical_region(
        step, (gates, p["r"], cache["c"], cache["n"], cache["m"], cache["h"]), (b4, (None,) * 4, b3, b3, b3, b3),
        [(b3, cache["c"].shape)] * 5, params=(1,))
    out = shard(einsum("bsd,de->bse", h_new.reshape(b, 1, d).to(x.dtype), p["out_proj"]), "batch", None, None)
    return out, {"c": c, "n": n, "m": m, "h": hh}
