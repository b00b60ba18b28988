"""The paper's own FL models: the MLP, the CNN (FMNIST, §VI-A) and the
compact ResNet (CIFAR-10), batched over the client cohort.

Counterpart of ``repro/models/vision.py``. Parameters are dicts in the
reference's layout (``w1`` is ``(in, hidden)``, ``x @ w1 + b1``;
convolution weights HWIO, images NHWC), so the flat vector of
:mod:`repro_torch.interop` is the reference's. Every function also takes a
cohort: leaves with a leading client axis ``M`` and inputs ``(M, B, ...)``.
The MLP serves the cohort with one batched matmul; the CNN and the ResNet
with one grouped convolution a layer (``groups = M``): activations are laid
out ``(B, M, C, H, W)``, which is ``(B, M*C, H, W)`` to ``F.conv2d``, and
each client's HWIO weight becomes ``M`` groups of OIHW filters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import prng

__all__ = [
    "init_mlp", "mlp_logits",
    "init_cnn", "cnn_logits",
    "init_resnet", "resnet_logits",
    "MODELS", "xent_loss", "accuracy",
]


def _dense_init(key, shape, device, scale=None):
    """``scale * normal`` (``scale`` defaults to ``shape[0] ** -0.5``), with
    the port's bit-exact :func:`repro_torch.prng.normal` drawn on the key's
    device."""
    scale = scale or shape[0] ** -0.5
    return scale * prng.normal(key, shape).to(device)


def _zeros(n, device):
    return torch.zeros(n, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(key: torch.Tensor, in_dim: int = 784, hidden: int = 128, classes: int = 10, *, device=None) -> dict:
    """Random MLP weights from a port key (see :func:`_dense_init`)."""
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w1": _dense_init(k1, (in_dim, hidden), device),
        "b1": _zeros(hidden, device),
        "w2": _dense_init(k2, (hidden, hidden), device),
        "b2": _zeros(hidden, device),
        "w3": _dense_init(k3, (hidden, classes), device),
        "b3": _zeros(classes, device),
    }


def _affine(x, w, b):
    return torch.matmul(x, w) + b.unsqueeze(-2)


def mlp_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., B, in) -> logits (..., B, classes); leaves may carry the
    same leading cohort dims as x."""
    h = torch.relu(_affine(x, params["w1"], params["b1"]))
    h = torch.relu(_affine(h, params["w2"], params["b2"]))
    return _affine(h, params["w3"], params["b3"])


# ---------------------------------------------------------------------------
# Convolutions over the cohort
# ---------------------------------------------------------------------------

def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: ``ceil(n / stride)`` outputs,
    the extra pixel of an odd total at the end (a 3x3 kernel at stride 2 on
    an even input pads (0, 1), not (1, 1))."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(h: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution of every client's images with its own HWIO kernel:
    h (B, M, C, H, W), w (M, kh, kw, C, O) -> (B, M, O, H', W'), one
    grouped convolution for the cohort."""
    bsz, m, c, hh, ww = h.shape
    kh, kw, _, o = w.shape[1:]
    wt = w.permute(0, 4, 3, 1, 2).reshape(m * o, c, kh, kw)
    (top, bottom), (left, right) = _same_pad(hh, kh, stride), _same_pad(ww, kw, stride)
    x = h.reshape(bsz, m * c, hh, ww)
    if (top, left) == (bottom, right):
        y = F.conv2d(x, wt, stride=stride, padding=(top, left), groups=m)
    else:
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), wt, stride=stride, groups=m)
    return y.view(bsz, m, o, *y.shape[-2:])


def _pool(h: torch.Tensor) -> torch.Tensor:
    """2x2 max pooling at stride 2, VALID (the reference's reduce_window)."""
    bsz, m, c, hh, ww = h.shape
    y = F.max_pool2d(h.reshape(bsz, m * c, hh, ww), 2, 2)
    return y.view(bsz, m, c, *y.shape[-2:])


def _cohort_images(x: torch.Tensor) -> torch.Tensor:
    """NHWC images of each client (M, B, H, W, C) -> (B, M, C, H, W)."""
    return x.permute(1, 0, 4, 2, 3).contiguous()


def _lift(tree: dict) -> dict:
    """One model's leaves as a cohort of one (a leading axis of size 1)."""
    return {k: _lift(v) if isinstance(v, dict) else v.unsqueeze(0) for k, v in tree.items()}


def _over_cohort(logits_fn, params: dict, x: torch.Tensor, single: bool, **kw) -> torch.Tensor:
    if single:
        return logits_fn(_lift(params), x.unsqueeze(0), **kw)[0]
    return logits_fn(params, x, **kw)


# ---------------------------------------------------------------------------
# CNN (the paper's FMNIST model)
# ---------------------------------------------------------------------------

def init_cnn(key: torch.Tensor, in_ch: int = 1, classes: int = 10, width: int = 16, img: int = 28, *,
             device=None) -> dict:
    """Random CNN weights (HWIO convolutions at scale 0.1), bit for bit the
    reference's at the same key."""
    device = key.device if device is None else device
    ks = prng.split(key, 4)
    flat = (img // 4) ** 2 * 2 * width
    return {
        "c1": _dense_init(ks[0], (3, 3, in_ch, width), device, scale=0.1),
        "c2": _dense_init(ks[1], (3, 3, width, 2 * width), device, scale=0.1),
        "w1": _dense_init(ks[2], (flat, 128), device),
        "b1": _zeros(128, device),
        "w2": _dense_init(ks[3], (128, classes), device),
        "b2": _zeros(classes, device),
    }


def _cnn_cohort(params: dict, x: torch.Tensor) -> torch.Tensor:
    m, bsz = x.shape[:2]
    h = _pool(torch.relu(_conv(_cohort_images(x), params["c1"])))
    h = _pool(torch.relu(_conv(h, params["c2"])))
    # flatten each image in NHWC order, the order of w1's rows
    h = h.permute(1, 0, 3, 4, 2).reshape(m, bsz, -1)
    h = torch.relu(_affine(h, params["w1"], params["b1"]))
    return _affine(h, params["w2"], params["b2"])


def cnn_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> (B, classes); or a cohort, x (M, B, H, W, C) and
    leaves with a leading M -> (M, B, classes)."""
    return _over_cohort(_cnn_cohort, params, x, params["c1"].dim() == 4)


# ---------------------------------------------------------------------------
# ResNet (the paper's CIFAR-10 model, ResNet-18 block layout)
# ---------------------------------------------------------------------------

def init_resnet(key: torch.Tensor, classes: int = 10, width: int = 16, blocks=(2, 2, 2, 2), in_ch: int = 3, *,
                device=None) -> dict:
    """ResNet-18 block layout; width=64 recovers the paper's scale. The 64
    keys of ``split(key, 64)`` go in loop order (stem; each block's c1, c2
    and proj where it has one; head_w), as in the reference."""
    device = key.device if device is None else device
    ks = iter(prng.split(key, 64))
    params: dict = {"stem": _dense_init(next(ks), (3, 3, in_ch, width), device, scale=0.1)}
    ch = width
    for si, n in enumerate(blocks):
        out_ch = width * (2**si)
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk = {
                "c1": _dense_init(next(ks), (3, 3, ch, out_ch), device, scale=0.1),
                "c2": _dense_init(next(ks), (3, 3, out_ch, out_ch), device, scale=0.1),
                "g1": torch.ones(out_ch, device=device),
                "b1": _zeros(out_ch, device),
                "g2": torch.ones(out_ch, device=device),
                "b2": _zeros(out_ch, device),
            }
            if stride != 1 or ch != out_ch:
                blk["proj"] = _dense_init(next(ks), (1, 1, ch, out_ch), device, scale=0.1)
            params[f"s{si}b{bi}"] = blk
            ch = out_ch
    params["head_w"] = _dense_init(next(ks), (ch, classes), device)
    params["head_b"] = _zeros(classes, device)
    return params


def _groupnorm(h: torch.Tensor, g: torch.Tensor, b: torch.Tensor, groups: int = 8) -> torch.Tensor:
    """The reference's group norm: statistics per (sample, client, group)
    with the population variance, eps 1e-5, then each client's affine.
    h (B, M, C, H, W), g and b (M, C)."""
    bsz, m, c, hh, ww = h.shape
    groups = min(groups, c)
    xg = h.reshape(bsz, m, groups, c // groups, hh, ww)
    mu = xg.mean(dim=(3, 4, 5), keepdim=True)
    var = (xg - mu).square().mean(dim=(3, 4, 5), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    return xg.reshape(h.shape) * g.view(1, m, c, 1, 1) + b.view(1, m, c, 1, 1)


def _resnet_cohort(params: dict, x: torch.Tensor, blocks) -> torch.Tensor:
    h = torch.relu(_conv(_cohort_images(x), params["stem"]))
    for si, n in enumerate(blocks):
        for bi in range(n):
            blk = params[f"s{si}b{bi}"]
            stride = 2 if (bi == 0 and si > 0) else 1
            r = _conv(h, blk["c1"], stride)
            r = torch.relu(_groupnorm(r, blk["g1"], blk["b1"]))
            r = _conv(r, blk["c2"])
            r = _groupnorm(r, blk["g2"], blk["b2"])
            sc = h if "proj" not in blk else _conv(h, blk["proj"], stride)
            h = torch.relu(r + sc)
    h = h.mean(dim=(3, 4)).transpose(0, 1)  # (M, B, C)
    return _affine(h, params["head_w"], params["head_b"])


def resnet_logits(params: dict, x: torch.Tensor, blocks=(2, 2, 2, 2)) -> torch.Tensor:
    """x (B, H, W, C) -> (B, classes); or a cohort, x (M, B, H, W, C) and
    leaves with a leading M -> (M, B, classes)."""
    return _over_cohort(_resnet_cohort, params, x, params["stem"].dim() == 4, blocks=blocks)


MODELS = {
    "mlp": (init_mlp, mlp_logits),
    "cnn": (init_cnn, cnn_logits),
    "resnet": (init_resnet, resnet_logits),
}


def xent_loss(logits_fn, params: dict, batch: dict) -> torch.Tensor:
    """Mean cross-entropy over the batch axis: a scalar, or (M,) per client.

    The label logit is picked with a one-hot product rather than a gather,
    so the backward pass has no scatter (and no atomics on the card), and
    the one-hot is a comparison, which needs no range check (and no sync).
    """
    logits = logits_fn(params, batch["x"])
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (batch["y"].long().unsqueeze(-1) == classes).to(logits.dtype)
    ll = (logits * onehot).sum(-1)
    return (torch.logsumexp(logits, -1) - ll).mean(-1)


def accuracy(logits_fn, params: dict, batch: dict) -> torch.Tensor:
    logits = logits_fn(params, batch["x"])
    return (logits.argmax(-1) == batch["y"].long()).float().mean(-1)
