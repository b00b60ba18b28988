"""The paper's MLP, batched over the client cohort.

Counterpart of the MLP half of ``repro/models/vision.py``; the CNN and the
ResNet come with a later slice. Parameters are a dict in the reference's
layout (``w1`` is ``(in, hidden)``, ``x @ w1 + b1``), and every function
also takes a cohort: leaves with a leading client axis ``M`` and inputs
``(M, B, in)``, so one batched matmul serves all clients.
"""

from __future__ import annotations

import torch

from .. import prng

__all__ = ["init_mlp", "mlp_logits", "xent_loss", "accuracy"]


def _dense_init(key, shape, device):
    """``shape[0] ** -0.5 * normal``, with the port's bit-exact
    :func:`repro_torch.prng.normal`."""
    return shape[0] ** -0.5 * prng.normal(key, shape).to(device)


def init_mlp(key: torch.Tensor, in_dim: int = 784, hidden: int = 128, classes: int = 10, *, device=None) -> dict:
    """Random MLP weights from a port key (see :func:`_dense_init`)."""
    k1, k2, k3 = prng.split(key, 3)
    z = lambda n: torch.zeros(n, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "w1": _dense_init(k1, (in_dim, hidden), device),
        "b1": z(hidden),
        "w2": _dense_init(k2, (hidden, hidden), device),
        "b2": z(hidden),
        "w3": _dense_init(k3, (hidden, classes), device),
        "b3": z(classes),
    }


def _affine(x, w, b):
    return torch.matmul(x, w) + b.unsqueeze(-2)


def mlp_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., B, in) -> logits (..., B, classes); leaves may carry the
    same leading cohort dims as x."""
    h = torch.relu(_affine(x, params["w1"], params["b1"]))
    h = torch.relu(_affine(h, params["w2"], params["b2"]))
    return _affine(h, params["w3"], params["b3"])


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
