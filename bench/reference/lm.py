"""Plain PyTorch reference of the federated LM round (a dense GQA decoder).

The model is the published decoder (RMSNorm, rotary attention with grouped
key-value heads and a bias on q, k and v, a SwiGLU FFN, an output head
that is the embedding's transpose where the configuration ties them)
written out with plain tensor operations in the configuration's
precision: parameters and matrix products in bf16, norms, rotary angles,
attention scores and the loss in f32. Parameters arrive as a dict of
leaves named as the program's parameter tree names them
(``blocks/0/mixer/wq`` with a leading layer axis).

One round (:func:`lm_round`): every client trains a copy of the global
model for the local steps, ``w - lr * (g + lam * (w - w0))`` rounded to
bf16 each step; each leaf's difference in f32 is compressed to one bit a
coordinate with probability ``0.5 + 0.5 * clip(delta, -b, b) / b`` against
the uniforms of :func:`threefry.chunk_uniforms` keyed
``fold_in(fold_in(round_key, leaf), client)``; the server counts the ones
``N`` and steps every leaf by ``(2 N - M) * f32(1/M) * b`` (Eq. 13); b
grows by 1.01 when more clients' last local loss fell below their first,
else shrinks by 0.98 (:func:`next_b`).

``precision="fp8"`` holds the residual stream and every matrix product's
operands in float8 e4m3 with one scale a tensor (the control: the next
precision below bf16). Imports nothing but torch and this folder.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import threefry

E4M3_MAX = 448.0


def recip32(n: int) -> float:
    return float(np.float32(1.0) / np.float32(n))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale (its largest magnitude
    maps to 448); the gradient passes through unrounded."""
    xd = x.detach()
    scale = xd.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    rounded = ((xd.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (rounded - xd)


class Decoder:
    """The decoder of a configuration file's widths."""

    def __init__(self, cfg: dict, precision: str = "bf16"):
        self.layers = cfg["num_hidden_layers"]
        self.d = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.hd = self.d // self.heads
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])
        self.precision = precision

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream as it is kept between layers."""
        return _fp8(x) if self.precision == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x (..., k) @ w (k, n)`` in the parameters' dtype."""
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps) * w.float()).to(x.dtype)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """Rotary embedding of (B, S, H, hd), the two halves rotated."""
        half = self.hd // 2
        inv = torch.pow(self.theta, -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
        a, b = x[..., :half].float(), x[..., half:].float()
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1).to(x.dtype)

    def attention(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """One layer's attention; ``p`` holds the layer's own leaves."""
        bsz, s, _ = x.shape
        q = self.mm(x, p["blocks/0/mixer/wq"].reshape(self.d, -1)).view(bsz, s, self.heads, self.hd)
        k = self.mm(x, p["blocks/0/mixer/wk"].reshape(self.d, -1)).view(bsz, s, self.kv, self.hd)
        v = self.mm(x, p["blocks/0/mixer/wv"].reshape(self.d, -1)).view(bsz, s, self.kv, self.hd)
        q = self.rope(q + p["blocks/0/mixer/bq"])
        k = self.rope(k + p["blocks/0/mixer/bk"])
        v = v + p["blocks/0/mixer/bv"]
        group = self.heads // self.kv
        qf = q.float().transpose(1, 2)  # (B, H, S, hd)
        kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
        vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
        scores = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(self.hd))
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        out = (torch.softmax(scores, dim=-1) @ vf).transpose(1, 2).reshape(bsz, s, self.d).to(x.dtype)
        return self.mm(out, p["blocks/0/mixer/wo"].reshape(-1, self.d))

    def ffn(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        gate = self.mm(x, p["blocks/0/ffn/w1"])
        up = self.mm(x, p["blocks/0/ffn/w3"])
        return self.mm(torch.nn.functional.silu(gate) * up, p["blocks/0/ffn/w2"])

    def loss(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` (B, S + 1): inputs
        ``tokens[:, :-1]``, targets ``tokens[:, 2:]`` (the trainer's labels
        ``tokens[:, 1:]`` shifted once more by the loss; the last input
        position has no target)."""
        x = self.store(p["embed/embed"][tokens[:, :-1]])
        stacked = {n: torch.unbind(w) for n, w in p.items() if n.startswith("blocks/")}
        for l in range(self.layers):
            layer = {n: w[l] for n, w in stacked.items()}
            x = self.store(x + self.attention(layer, self.norm(x, layer["blocks/0/norm1/w"])))
            x = self.store(x + self.ffn(layer, self.norm(x, layer["blocks/0/norm2/w"])))
        x = self.norm(x, p["final_norm/w"])
        head = p["embed/head"] if "embed/head" in p else p["embed/embed"].T
        logits = self.mm(x, head).float()[:, :-1]
        target = tokens[:, 2:]
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, target[..., None].long())[..., 0]
        return nll.mean()


def local_step(w: torch.Tensor, g: torch.Tensor, w0: torch.Tensor, lr: float, lam: float) -> torch.Tensor:
    """``w - lr * (g + lam * (w - w0))`` in f32 with both multiply-adds
    fused (each product exact in f64, each sum rounded to f32 once), with
    the f32 values of ``lr`` and ``lam``, rounded to ``w``'s dtype."""
    lr, lam = float(np.float32(lr)), float(np.float32(lam))
    wf = w.float()
    step = (lam * (wf - w0.float()).double() + g.double()).float()
    return (-lr * step.double() + wf.double()).float().to(w.dtype)


def eq5_probability(delta: torch.Tensor, b: float) -> torch.Tensor:
    """``0.5 + 0.5 * clip(delta, -b, b) / b`` in f32 (Eq. 5), dividing by b
    as a tensor: torch divides by a Python number through its reciprocal,
    an ulp away from the quotient."""
    b = torch.tensor(b, dtype=torch.float32, device=delta.device)
    return 0.5 + 0.5 * torch.clamp(delta, -b, b) / b


def mean32(values: list) -> float:
    """The cohort's mean as the trainer reports it: an f32 sum times
    f32(1/M)."""
    return float(np.float32(np.sum(np.float32(values), dtype=np.float32)) * np.float32(recip32(len(values))))


def next_b(b: float, first: list, last: list, up: float = 1.01, down: float = 0.98) -> float:
    """b after the clients' loss votes: +1 where a client's last local loss
    fell below its first; ``up`` on a positive sum, else ``down``, in f32."""
    vote = sum(1 if lo < fi else -1 for fi, lo in zip(first, last))
    return float(torch.tensor(b, dtype=torch.float32) * torch.tensor(up if vote > 0 else down, dtype=torch.float32))


def lm_round(model: Decoder, params: dict, names: list, b: float, tokens: torch.Tensor, round_key: torch.Tensor,
             lr: float, lam: float):
    """One round from ``params`` (leaves in the wire's leaf order ``names``)
    on ``tokens`` (M, steps, B, S + 1). Returns ``(params', losses)``: each
    client's local loss at every step, (M, steps) floats."""
    m = tokens.shape[0]
    counts = {n: torch.zeros(params[n].shape, dtype=torch.int16, device=params[n].device) for n in names}
    b = float(np.float32(b))
    losses = []
    for g in range(m):
        local = dict(params)
        losses.append([])
        for t in range(tokens.shape[1]):
            req = {n: local[n].detach().requires_grad_(True) for n in names}
            loss = model.loss(req, tokens[g, t])
            grads = torch.autograd.grad(loss, [req[n] for n in names])
            losses[-1].append(float(loss.detach()))
            with torch.no_grad():
                local = {n: local_step(local[n], gr, params[n], lr, lam) for n, gr in zip(names, grads)}
            del grads, req
        with torch.no_grad():
            for i, n in enumerate(names):
                delta = (local[n].float() - params[n].float()).reshape(-1)
                u = threefry.chunk_uniforms(threefry.fold_in(threefry.fold_in(round_key, i), g), delta.numel())
                counts[n] += (u < eq5_probability(delta, b)).view(counts[n].shape)
                del delta, u
        del local
    with torch.no_grad():
        new = {n: (params[n].float() + (2.0 * counts[n].float() - m) * recip32(m) * b).to(params[n].dtype)
               for n in names}
    return new, losses
