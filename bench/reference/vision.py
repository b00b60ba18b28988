"""Plain PyTorch reference of the paper's federated vision round.

The model is ResNet-18 as the paper trains it on CIFAR-10 (width 64,
blocks 2-2-2-2, GroupNorm of 8 groups, no bias on the convolutions, a
dense head after global average pooling), one client at a time, in f32.
Its parameters are one flat f32 vector in the wire's order: the leaves of
the nested dict sorted by key at every level (``head_b``, ``head_w``,
``s0b0`` with ``b1``, ``b2``, ``c1``, ``c2``, ``g1``, ``g2``, ``proj``,
..., ``stem``), each leaf row-major, convolution kernels HWIO. Images are
NHWC; a convolution pads as XLA's "SAME" does (the extra pixel of an odd
total at the end).

One round (:func:`vision_round`), on the key schedule of the simulation
(``key, kb, kr = split(key, 3)`` a round): client ``m`` draws its batch
indices ``randint(fold_in(kb, m), (steps, batch))``, trains from its own
model with momentum SGD toward the global one (``g + lam (w - w0)``,
``m' = mu m + g``, ``w' = w - lr m'``, one rounding an operation), and
uploads one bit a coordinate with probability ``0.5 + 0.5 clip(delta, -b,
b) / b`` against the uniforms keyed ``fold_in(k_q, m)`` with ``k_q =
split(fold_in(kr, 1))[1]``; the server steps by ``(2 N - M) f32(1/M) b``
(Eq. 13) and b by 1.01 or 0.98 on the clients' loss votes.

``precision="tf32"`` runs the convolutions and matrix products in TF32
(the control: the next precision below f32 with TF32 off). Imports
nothing but torch and this folder.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import threefry
from .lm import eq5_probability


def recip32(n: int) -> float:
    return float(np.float32(1.0) / np.float32(n))


def leaf_shapes(cfg: dict) -> dict:
    """The nested dict of leaf shapes of a configuration file's ResNet."""
    width, c_in, classes = cfg["width"], cfg["in_channels"], cfg["classes"]
    tree: dict = {"stem": (3, 3, c_in, width)}
    ch = width
    for si, n in enumerate(cfg["blocks"]):
        out = width * 2**si
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk = {"c1": (3, 3, ch, out), "c2": (3, 3, out, out), "g1": (out,), "b1": (out,), "g2": (out,),
                   "b2": (out,)}
            if stride != 1 or ch != out:
                blk["proj"] = (1, 1, ch, out)
            tree[f"s{si}b{bi}"] = blk
            ch = out
    tree["head_w"] = (ch, classes)
    tree["head_b"] = (classes,)
    return tree


def flat_leaves(tree: dict, prefix: str = "") -> list:
    """``(name, shape)`` of every leaf in the wire's order (keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        out.extend(flat_leaves(v, name + "/") if isinstance(v, dict) else [(name, tuple(v))])
    return out


def same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class ResNet:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.leaves = flat_leaves(leaf_shapes(cfg))
        self.sizes = [math.prod(s) for _, s in self.leaves]
        self.groups = cfg["groupnorm_groups"]

    @property
    def d(self) -> int:
        return sum(self.sizes)

    def unravel(self, w: torch.Tensor) -> dict:
        return {n: part.view(s) for (n, s), part in zip(self.leaves, torch.split(w, self.sizes))}

    def conv(self, x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
        kh, kw = w_hwio.shape[:2]
        (top, bottom), (left, right) = same_pad(x.shape[2], kh, stride), same_pad(x.shape[3], kw, stride)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w_hwio.permute(3, 2, 0, 1).contiguous(), stride=stride)

    def gn(self, x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, min(self.groups, x.shape[1]), g, b, eps=1e-5)

    def logits(self, p: dict, images: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv(images.permute(0, 3, 1, 2).contiguous(), p["stem"]))
        for si, n in enumerate(self.cfg["blocks"]):
            for bi in range(n):
                k = f"s{si}b{bi}/"
                stride = 2 if (bi == 0 and si > 0) else 1
                r = torch.relu(self.gn(self.conv(h, p[k + "c1"], stride), p[k + "g1"], p[k + "b1"]))
                r = self.gn(self.conv(r, p[k + "c2"]), p[k + "g2"], p[k + "b2"])
                sc = self.conv(h, p[k + "proj"], stride) if k + "proj" in p else h
                h = torch.relu(r + sc)
        return h.mean(dim=(2, 3)) @ p["head_w"] + p["head_b"]

    def loss(self, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        logits = self.logits(self.unravel(w), x)
        return (torch.logsumexp(logits, -1) - logits.gather(-1, y.long()[:, None])[:, 0]).mean()


@contextlib.contextmanager
def precision(name: str):
    """TF32 on for ``"tf32"``, off for ``"f32"``; restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_keys(key: torch.Tensor):
    """``(next key, batch key, quantizer key)`` of a round."""
    ks = threefry.split(key, 3)
    return ks[0], ks[1], threefry.split(threefry.fold_in(ks[2], 1), 2)[1]


def batch_indices(kb: torch.Tensor, m: int, steps: int, batch: int, per_client: int) -> torch.Tensor:
    return threefry.randint(threefry.fold_in(kb, m), steps * batch, per_client).view(steps, batch)


def constants(traffic: dict) -> tuple:
    """``(lr, momentum, lam)`` as the f32 values the round uses."""
    return tuple(float(np.float32(traffic[k])) for k in ("lr", "momentum", "lam"))


def prox_step(model: ResNet, w, mom, w0, x, y, traffic: dict):
    """One local step: the gradient at ``w``, then ``g + lam (w - w0)``,
    ``m' = mu m + g``, ``w' = w - lr m'``. Returns ``(w', m')``."""
    lr, mu, lam = constants(traffic)
    wr = w.detach().requires_grad_(True)
    g = torch.autograd.grad(model.loss(wr, x, y), wr)[0]
    with torch.no_grad():
        g = g + lam * (w - w0)
        mom = mu * mom + g
        return w - lr * mom, mom


def estimate(deltas: torch.Tensor, b: float, k_q: torch.Tensor) -> torch.Tensor:
    """Eq. 13 from every client's one-bit upload of its row of ``deltas``."""
    m_clients, d = deltas.shape
    counts = torch.zeros(d, dtype=torch.int32, device=deltas.device)
    for m in range(m_clients):
        u = threefry.chunk_uniforms(threefry.fold_in(k_q, m), d)
        counts += u < eq5_probability(deltas[m], b)
    return (2.0 * counts.float() - m_clients) * recip32(m_clients) * b


def next_b(b: float, before: torch.Tensor, after: torch.Tensor) -> float:
    vote = float(torch.where(after < before, 1.0, -1.0).sum())
    return float(torch.tensor(b, dtype=torch.float32) * torch.tensor(1.01 if vote > 0 else 0.98, dtype=torch.float32))


def mean_loss(after: torch.Tensor) -> float:
    return float(after.sum() * recip32(after.numel()))


def vision_round(model: ResNet, state: dict, key: torch.Tensor, client_x: torch.Tensor, client_y: torch.Tensor,
                 traffic: dict, watch: tuple = ()):
    """One round from ``state`` (``w_global`` (d,), ``w_locals`` (M, d),
    ``b``) and the simulation key. Returns the next state, the next key and
    what the round produced: the mean last local loss, each client's first
    and last local loss, theta, every client's weights after its first
    local step (``first_step``, (M, d)), and the weights and momentum of
    the clients ``watch`` entering each local step (``chain_w``,
    ``chain_m``: a (len(watch), d) tensor a step)."""
    m_clients, per_client = client_x.shape[:2]
    steps = max(traffic["local_epochs"] * per_client // traffic["batch_size"], 1)
    key, kb, k_q = round_keys(key)
    w0, b = state["w_global"], float(state["b"])
    w_locals = state["w_locals"].clone()
    first_step = torch.empty_like(w_locals)
    chain = {m: ([], []) for m in watch}
    before, after = [], []
    for m in range(m_clients):
        idx = batch_indices(kb, m, steps, traffic["batch_size"], per_client)
        xs, ys = client_x[m][idx], client_y[m][idx]
        w = w_locals[m].clone()
        mom = torch.zeros_like(w)
        with torch.no_grad():
            before.append(model.loss(w, xs[0], ys[0]))
        for s in range(steps):
            if m in chain:
                chain[m][0].append(w.to("cpu"))
                chain[m][1].append(mom.to("cpu"))
            w, mom = prox_step(model, w, mom, w0, xs[s], ys[s], traffic)
            if s == 0:
                first_step[m] = w
        with torch.no_grad():
            after.append(model.loss(w, xs[-1], ys[-1]))
            w_locals[m] = w
    before, after = torch.stack(before), torch.stack(after)
    with torch.no_grad():
        theta = estimate(w_locals - w0, b, k_q)
    out = {"loss": mean_loss(after), "before": before.cpu(), "after": after.cpu(), "theta": theta.cpu(),
           "first_step": first_step.cpu(),
           "chain_w": [torch.stack([chain[m][0][s] for m in watch]) for s in range(steps)] if watch else [],
           "chain_m": [torch.stack([chain[m][1][s] for m in watch]) for s in range(steps)] if watch else []}
    return {"w_global": w0 + theta, "w_locals": w_locals, "b": next_b(b, before, after)}, key, out
