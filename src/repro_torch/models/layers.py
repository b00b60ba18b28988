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

On the model axis (DTensor parameters) the activations carry the
reference's ``shard`` annotations; the attention core, the vocab-sharded
embedding lookup and the loss run on each rank's local shards
(:func:`repro_torch.distributed.local_region`): the core on its batch and
head shards, each query head with its own key-value head; the lookup as
each vocab shard's masked rows, summed over the vocab shards (one row is
not zero, so the sum is exact); the loss on the batch shards of the
logits gathered over the vocabulary, its sums added over the batch
shards.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import distributed
from ..core.aggregation import recip32
from ..distributed import einsum, shard
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
    "attn_cache_logical",
    "decode_attention_block",
    "ffn_specs",
    "ffn_block",
    "embed_specs",
    "embed_tokens",
    "lm_logits",
    "softmax_xent",
    "next_token_xent",
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
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv", None)
    v = shard(v, "batch", None, "kv", None)
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


_Q_LOGICAL, _KV_LOGICAL = ("batch", None, "heads", None), ("batch", None, "kv", None)


def _kv_heads_of_local_q(q, k, n_heads: int, n_kv: int):
    """On a mesh: the local key-value head of each local query head (None
    when the local heads group as the whole model's do)."""
    mesh = q.device_mesh
    lq, off_q = distributed.shard_bounds(q.shape, mesh, distributed.placements_for(mesh, _Q_LOGICAL, tuple(q.shape)))
    lk, off_k = distributed.shard_bounds(k.shape, mesh, distributed.placements_for(mesh, _KV_LOGICAL, tuple(k.shape)))
    g = n_heads // n_kv
    idx = [(off_q[2] + j) // g - off_k[2] for j in range(lq[2])]
    natural = lq[2] % lk[2] == 0 and idx == [j // (lq[2] // lk[2]) for j in range(lq[2])]
    return None if natural else idx


def _attention_core(q, k, v, cfg: ModelConfig):
    """``chunked_attention``; on DTensors, on each rank's batch and head
    shards (a query head whose key-value head another rank holds reads
    its own copy: the key-value heads are then replicated)."""
    if not distributed.is_dtensor(q):
        return chunked_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    idx = _kv_heads_of_local_q(q, k, cfg.n_heads, cfg.n_kv_heads)

    def local(ql, kl, vl):
        if idx is not None:
            sel = torch.tensor(idx, device=kl.device)
            kl, vl = kl.index_select(2, sel), vl.index_select(2, sel)
        return chunked_attention(ql, kl, vl, causal=cfg.causal, window=cfg.sliding_window)

    return distributed.logical_region(local, (q, k, v), (_Q_LOGICAL, _KV_LOGICAL, _KV_LOGICAL),
                                      (_Q_LOGICAL, q.shape))


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    q, k, v = _qkv(p, x, cfg, positions)
    out = _attention_core(q, k, v, cfg)
    return shard(einsum("bshk,hkd->bsd", out, p["wo"]), "batch", None, None)


# -- decode ------------------------------------------------------------------

def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def attn_cache_logical() -> dict:
    return {"k": ("batch", "seq", "kv", None), "v": ("batch", "seq", "kv", None)}


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
    if distributed.is_dtensor(q):
        out, cache = _sharded_decode_attention(q, k, v, cache, cfg, pos, slot, window)
        return shard(einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"]), "batch", None, None), cache
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
    return einsum("bshk,hkd->bsd", out, p["wo"]), cache


_CACHE_LOGICAL = ("batch", "seq", "kv", None)


def _sharded_decode_attention(q, k, v, cache: dict, cfg: ModelConfig, pos: int, slot: int, window: int):
    """The decode attention on DTensors: each rank holds a batch and
    sequence shard of the caches (the reference's ``("batch", "seq", "kv",
    None)``), writes the new key and value if the slot is its own, and
    takes the softmax over its slots; the shards' maxima and sums are
    combined over the sequence's mesh dimension (a flash-decode). Returns
    the (B, 1, H, hd) f32 output and the new caches."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Shard

    mesh = q.device_mesh
    c_pl = distributed.placements_for(mesh, _CACHE_LOGICAL, tuple(cache["k"].shape))
    (_, rows, _, _), (_, row0, _, _) = distributed.shard_bounds(cache["k"].shape, mesh, c_pl)
    seq_dims = [i for i, pl in enumerate(c_pl) if isinstance(pl, Shard) and pl.dim == 1]
    groups = [mesh.get_group(i) for i in seq_dims]
    cache_len, KV, hd, H = cache["k"].shape[1], cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    q_log, kv_log = ("batch", None, None, None), ("batch", None, None, None)

    def local(ql, kl, vl, ck, cv):
        ck, cv = ck.clone(), cv.clone()
        if row0 <= slot < row0 + rows:
            ck[:, slot - row0] = kl[:, 0].to(ck.dtype)
            cv[:, slot - row0] = vl[:, 0].to(cv.dtype)
        b = ql.shape[0]
        qg = ql.reshape(b, KV, H // KV, hd).float()
        logits = torch.einsum("bkgh,bskh->bkgs", qg, ck.float()) * recip32(math.sqrt(hd))
        idx = row0 + torch.arange(rows, device=ql.device)
        valid = idx <= pos if window <= 0 else idx < min(pos + 1, cache_len)
        logits = logits + torch.where(valid, 0.0, NEG_INF)
        mx = logits.amax(-1, keepdim=True)
        for g in groups:
            mx = funcol.all_reduce(mx, "max", g)
        e = torch.exp(logits - mx)
        den = e.sum(-1, keepdim=True)
        num = torch.einsum("bkgs,bskh->bkgh", e, cv.float())
        for g in groups:
            den, num = funcol.all_reduce(den, "sum", g), funcol.all_reduce(num, "sum", g)
        return (num / den[..., 0, None]).reshape(b, 1, H, hd), ck, cv

    c_shape = tuple(cache["k"].shape)
    out, ck, cv = distributed.logical_region(
        local, (q, k, v, cache["k"], cache["v"]), (q_log, kv_log, kv_log, _CACHE_LOGICAL, _CACHE_LOGICAL),
        [(q_log, q.shape), (_CACHE_LOGICAL, c_shape), (_CACHE_LOGICAL, c_shape)])
    return out, {"k": shard(ck, *_CACHE_LOGICAL), "v": shard(cv, *_CACHE_LOGICAL)}


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
    h = shard(einsum("bsd,df->bsf", x, p["w1"]), "batch", None, "ff")
    if "w3" in p:
        h = F.silu(h) * einsum("bsd,df->bsf", x, p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    return shard(einsum("bsf,fd->bsd", h, p["w2"]), "batch", None, None)


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    s = {"embed": LeafSpec((cfg.vocab, cfg.d_model), ("vocab", None), scale=1.0)}
    if not cfg.tie_embeddings:
        s["head"] = LeafSpec((cfg.d_model, cfg.vocab), (None, "vocab"))
    return s


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    w = p["embed"]
    if not distributed.is_dtensor(w):
        return w[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = w.device_mesh
    t_pl = distributed.placements_for(mesh, ("batch", None), tuple(tokens.shape))
    if not distributed.is_dtensor(tokens):
        tokens = distributed.keep_shard(tokens, mesh, t_pl)
    # a mesh dimension that splits the tokens gathers its part of the vocabulary
    w_pl = tuple(Replicate() if isinstance(pt, Shard) else pw for pw, pt in zip(
        distributed.placements_for(mesh, ("vocab", None), tuple(w.shape)), t_pl))
    (rows, _), (row0, _) = distributed.shard_bounds(w.shape, mesh, w_pl)
    out_pl = distributed.placements_for(mesh, ("batch", None, None), tuple(tokens.shape) + (w.shape[1],))
    out_pl = tuple(Partial() if isinstance(pw, Shard) else po for pw, po in zip(w_pl, out_pl))
    grad_pl = tuple(pw if isinstance(pw, Shard) else (Partial() if isinstance(pt, Shard) else pw)
                    for pw, pt in zip(w_pl, t_pl))

    def local(wl, tl):
        if rows == w.shape[0]:
            return wl[tl]
        idx = tl.long() - row0
        inside = (idx >= 0) & (idx < rows)
        got = wl[torch.where(inside, idx, torch.zeros_like(idx))]
        return torch.where(inside[..., None], got, torch.zeros_like(got))

    out = distributed.local_region(local, (w, tokens), (w_pl, t_pl), out_pl, in_grad_placements=(grad_pl, t_pl))
    return shard(out, "batch", None, None)


def lm_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) f32: the head's product in the parameters' dtype, widened."""
    head = p.get("head")
    if head is None:
        head = p["embed"].T
    return shard(einsum("bsd,dv->bsv", x, head).float(), "batch", None, "vocab")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy; logits (B, S, V) f32, labels (B, S) int (on
    DTensor logits, :func:`_sharded_xent`)."""
    if distributed.is_dtensor(logits):
        return _sharded_xent(logits, labels, mask, shift=False)
    return _xent(logits, labels, mask)


def next_token_xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """The next-token loss: the labels rolled left by one, the last position
    masked out, with ``mask`` when given."""
    if distributed.is_dtensor(logits):
        return _sharded_xent(logits, labels, mask, shift=True)
    return _xent(logits, *_next_tokens(labels, mask))


def _next_tokens(labels: torch.Tensor, mask: torch.Tensor | None):
    shifted = torch.roll(labels, -1, dims=1)
    mask = torch.ones_like(labels, dtype=torch.bool) if mask is None else mask.clone()
    mask[:, -1] = False  # last position has no next token
    return shifted, mask


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]


def _sharded_xent(logits, labels, mask, shift: bool):
    """The loss of DTensor logits: each rank's batch shard of the logits,
    gathered over the vocabulary, gives the sums of its masked losses and
    mask, which are added over the batch shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    lg_pl = distributed.placements_for(mesh, ("batch", None, None), tuple(logits.shape))
    tok_pl = distributed.placements_for(mesh, ("batch", None), tuple(labels.shape))

    def own(t):
        return t if t is None or distributed.is_dtensor(t) else distributed.keep_shard(t, mesh, tok_pl)

    def local(lg, lab, m):
        if shift:
            lab, m = _next_tokens(lab, m)
        nll = _nll(lg, lab)
        if m is None:
            return torch.stack([nll.sum(), torch.tensor(float(nll.numel()), device=lg.device)])
        mf = m.float()
        return torch.stack([(nll * mf).sum(), mf.sum()])

    sums_pl = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in lg_pl)
    args = (logits, own(labels), own(mask))
    sums = distributed.local_region(local, args, (lg_pl, tok_pl, None if mask is None else tok_pl), sums_pl)
    sums = sums.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return sums[0] / torch.clamp(sums[1], min=1.0)


def _xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    nll = _nll(logits, labels)
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
