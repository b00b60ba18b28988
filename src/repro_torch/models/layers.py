"""Shared neural layers of the dense attention family, prefill side: norms,
RoPE, chunked (flash-style) GQA attention with causal and sliding-window
masks, the dense FFN, the embedding, the LM head and the loss.

Counterpart of ``repro/models/layers.py``. All forwards are pure functions
of (params, inputs); parameter structures are declared by the ``*_specs``
functions as LeafSpec trees. The reference computes attention and the
projections in plain ``jnp`` outside any Pallas kernel; so does the port,
with ``torch.einsum``. The dtypes follow the reference: projections in the
parameters' dtype (bf16 by default), attention logits, softmax and norms
in f32, the LM head's product rounded to the parameters' dtype and then
widened to f32. :func:`decode_attention_block` is the one-token decode
over a bf16 KV cache (:func:`init_attn_cache`), linear or a ring of
``window`` slots. :func:`causal_conv1d` is the xLSTM and Mamba mixers'
depthwise convolution.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.aggregation import recip32
from .config import ModelConfig
from .spec import LeafSpec

__all__ = [
    "NEG_INF",
    "norm_specs",
    "apply_norm",
    "apply_rope",
    "attn_specs",
    "chunked_attention",
    "attention_block",
    "init_attn_cache",
    "decode_attention_block",
    "ffn_specs",
    "ffn_block",
    "embed_specs",
    "embed_tokens",
    "lm_logits",
    "softmax_xent",
    "causal_conv1d",
]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": LeafSpec((d,), (None,), "ones"), "b": LeafSpec((d,), (None,), "zeros")}
    return {"w": LeafSpec((d,), (None,), "ones")}


def apply_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm, or layer norm when ``p`` has a bias (variance with
    ``ddof = 0``, as ``jnp.var``), in f32, cast back to ``x``'s dtype."""
    xf = x.float()
    if "b" in p:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["w"].float() + p["b"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["w"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. The f32 ``theta ** (-i/half)``
    may differ from XLA's ``pow`` by an ulp (ROADMAP C)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    s: dict = {
        "wq": LeafSpec((d, cfg.n_heads, hd), (None, "heads", None)),
        "wk": LeafSpec((d, cfg.n_kv_heads, hd), (None, "kv", None)),
        "wv": LeafSpec((d, cfg.n_kv_heads, hd), (None, "kv", None)),
        "wo": LeafSpec((cfg.n_heads, hd, d), ("heads", None, None)),
    }
    if cfg.qkv_bias:
        s["bq"] = LeafSpec((cfg.n_heads, hd), ("heads", None), "zeros")
        s["bk"] = LeafSpec((cfg.n_kv_heads, hd), ("kv", None), "zeros")
        s["bv"] = LeafSpec((cfg.n_kv_heads, hd), ("kv", None), "zeros")
    return s


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention in O(S * chunk) memory (flash-style), the
    reference's chunk loops and running max / sum in the same order.

    q: (B, S, H, hd);  k, v: (B, S, KV, hd).  GQA via H = KV * G grouping.
    ``window > 0`` restricts keys to ``(i - window, i]``.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    cq = min(chunk_q, S)
    ck = min(chunk_kv, S)
    if S % cq or S % ck:
        raise ValueError(f"sequence {S} is not a whole number of chunks ({cq}, {ck})")
    dev = q.device
    qg = q.reshape(B, S, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, S, cq):
        qc = qg[:, q0 : q0 + cq]
        qpos = q0 + torch.arange(cq, device=dev)
        acc = torch.zeros((B, cq, KV, G, hd), dtype=torch.float32, device=dev)
        mx = torch.full((B, cq, KV, G), NEG_INF, dtype=torch.float32, device=dev)
        lse = torch.zeros((B, cq, KV, G), dtype=torch.float32, device=dev)
        for k0 in range(0, S, ck):
            kpos = k0 + torch.arange(ck, device=dev)
            logits = torch.einsum("bqkgh,bckh->bqkgc", qc, kf[:, k0 : k0 + ck]) * scale
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            logits = torch.where(mask[None, :, None, None, :], logits, torch.full_like(logits, NEG_INF))
            new_mx = torch.maximum(mx, logits.amax(-1))
            alpha = torch.exp(mx - new_mx)
            p_exp = torch.exp(logits - new_mx[..., None])
            lse = lse * alpha + p_exp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p_exp, vf[:, k0 : k0 + ck])
            mx = new_mx
        outs.append(acc / torch.clamp(lse[..., None], min=1e-30))
    out = torch.cat(outs, dim=1).reshape(B, S, H, hd)
    return out.to(q.dtype)


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    q, k, v = _qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# -- decode ------------------------------------------------------------------

def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def decode_attention_block(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig, pos: int,
                           window: int) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, d); ``pos`` the token's position.
    ``window > 0``: a ring-buffer cache of that size (slot ``pos % window``);
    otherwise a linear cache of full length. The new key and value are
    written into ``cache`` in place, which is returned.

    Like the reference, only ``window`` bounds the keys: ``cfg.sliding_window``
    is not read here (ROADMAP C). The logits are scaled by the f32
    reciprocal of ``sqrt(hd)``, as XLA rewrites the reference's division by
    the constant under ``jit``.
    """
    B = x.shape[0]
    cache_len = cache["k"].shape[1]
    slot = pos % window if window > 0 else pos
    if not 0 <= slot < cache_len:
        raise ValueError(f"position {pos} is past the cache's {cache_len} slots")
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)  # (B,1,H,hd), (B,1,KV,hd)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(B, KV, cfg.n_heads // KV, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, cache["k"].float()) * recip32(math.sqrt(hd))
    idx = torch.arange(cache_len, device=x.device)
    # ring buffer: every slot valid once the window has wrapped
    valid = idx <= pos if window <= 0 else idx < min(pos + 1, cache_len)
    logits = logits + torch.where(valid, 0.0, NEG_INF)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = e / e.sum(-1, keepdim=True)  # jax.nn.softmax
    out = torch.einsum("bkgs,bskh->bkgh", w, cache["v"].float())
    out = out.reshape(B, 1, cfg.n_heads, hd).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def ffn_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.ffn_act == "swiglu":
        return {
            "w1": LeafSpec((d, f), (None, "ff")),
            "w3": LeafSpec((d, f), (None, "ff")),
            "w2": LeafSpec((f, d), ("ff", None)),
        }
    return {
        "w1": LeafSpec((d, f), (None, "ff")),
        "w2": LeafSpec((f, d), ("ff", None)),
    }


def ffn_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU, or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    h = torch.einsum("bsd,df->bsf", x, p["w1"])
    if "w3" in p:
        h = F.silu(h) * torch.einsum("bsd,df->bsf", x, p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["w2"])


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    s = {"embed": LeafSpec((cfg.vocab, cfg.d_model), ("vocab", None), scale=1.0)}
    if not cfg.tie_embeddings:
        s["head"] = LeafSpec((cfg.d_model, cfg.vocab), (None, "vocab"))
    return s


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def lm_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) f32: the head's product in the parameters' dtype, widened."""
    head = p.get("head")
    if head is None:
        head = p["embed"].T
    return torch.einsum("bsd,dv->bsv", x, head).float()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy; logits (B, S, V) f32, labels (B, S) int."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    nll = lse - ll
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (K, C). The reference's
    Python ``sum`` of K shifted products in its order; in bf16 each product
    and partial sum rounds, where XLA may keep the fused chain in f32
    (ROADMAP C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    if b is not None:
        out = out + b[None, None, :]
    return out
