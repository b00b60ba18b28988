"""SGD with momentum over parameter trees, and the prox-regularized local
solver (paper Eq. 4), batched over clients.

Counterpart of ``repro/optim/sgd.py``. :func:`sgd_momentum_init` and
:func:`sgd_momentum_step` map the reference's tree functions over the
port's trees (:func:`repro_torch.tree.tree_map`). Clients minimize
``f_m(w) + (lam/2) ||w - w_g||^2`` with momentum SGD. The reference vmaps
one client's ``lax.scan`` (and its campaign engine vmaps that over (cell,
seed) elements); here every client row of one or more runs steps together:
each local step takes one autograd gradient for all rows (their losses are
independent, so the gradient of their sum is every client's own) and one
fused prox step on them through ``ops.prox_sgd``: with ``use_kernel`` one
launch of the ``prox_sgd`` kernel on a CUDA tensor, without it the plain
version (``engine="ref"``) on any device. A group of E runs (a campaign
group) passes each run's global model as a row of ``w0`` (E, d) and its
``lr``, ``mu`` and ``lam`` as (E,) tensors; its rows are the E cohorts one
after another. Each run's losses and gradient are taken on its own rows,
a view of the group's plane: on the card a run's gradient computed among
all E runs' rows differs from the run's own in the last bits (the GEMM
kernels and reductions follow the batch's shape), while on its own rows it
is the single run's bit for bit; the prox step is one launch for the
group. The step updates the weights and momentum in place (JAX returns new
arrays; the values are the same), and never writes into ``w_init``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import ops as kops
from ..tree import tree_map

__all__ = ["sgd_momentum_init", "sgd_momentum_step", "local_prox_train"]


def sgd_momentum_init(params):
    """Zero momentum of the tree ``params``."""
    return tree_map(torch.zeros_like, params)


def sgd_momentum_step(params, moms, grads, lr: float, mu: float):
    """One momentum step: ``m' = mu m + g``, ``p' = p - lr m'``; returns
    ``(params', moms')`` as new trees."""
    new_moms = tree_map(lambda m, g: mu * m + g, moms, grads)
    new_params = tree_map(lambda p, m: p - lr * m, params, new_moms)
    return new_params, new_moms


def local_prox_train(
    loss_fn: Callable,
    w0_flat: torch.Tensor,
    w_init: torch.Tensor,
    unravel: Callable,
    batches: dict,
    *,
    lr,
    mu,
    lam,
    use_kernel: bool = False,
    engine: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the local steps of every client over pre-drawn batches.

    ``w0_flat`` (d,) is the global model, ``w_init`` (M, d) the clients'
    starting points, ``batches`` leaves ``(M, n_steps, batch, ...)``;
    ``loss_fn(params, batch)`` returns one loss per client. ``lr``, ``mu``
    and ``lam`` are numbers. For a group of E runs, ``w0_flat`` is (E, d),
    ``w_init`` and the batches hold the E cohorts' rows one after another
    (each run's losses and gradient taken on its own rows), and ``lr``,
    ``mu`` and ``lam`` are (E,) f32 tensors. Returns
    ``(w_final (M, d), loss_first (M,), loss_last (M,))``: the loss before
    training on the first batch and after it on the last, the two values
    the dynamic-b controller's loss bit compares.
    """
    n_steps = next(iter(batches.values())).shape[1]
    coeffs = kops.prox_coeffs(lr, lam, mu, w_init.device)
    runs = w0_flat.numel() // w0_flat.shape[-1]
    per = w_init.shape[0] // runs
    spans = [slice(i * per, (i + 1) * per) for i in range(runs)]

    def step_batch(s):
        return {k: v[:, s] for k, v in batches.items()}

    def run_batch(batch, span):
        return {k: v[span] for k, v in batch.items()}

    def data_loss(w, batch):
        losses = [loss_fn(unravel(w[span]), run_batch(batch, span)) for span in spans]
        return losses[0] if runs == 1 else torch.cat(losses)

    # a group's gradient: one buffer for every step, written a run's rows at a time
    g = torch.empty_like(w_init) if runs > 1 else None

    def gradient(w, batch):
        for span in spans:
            wg = w[span].detach().requires_grad_(True)
            grad = torch.autograd.grad(loss_fn(unravel(wg), run_batch(batch, span)).sum(), wg)[0]
            if g is None:
                return grad
            g[span] = grad
        return g

    with torch.no_grad():
        loss_before = data_loss(w_init, step_batch(0))
    w = w_init
    m = torch.zeros_like(w_init)
    for s in range(n_steps):
        g = gradient(w, step_batch(s))
        # in place from step 1 on; step 0 writes a fresh buffer, since the
        # caller still holds w_init
        w_out = w if s else torch.empty_like(w_init)
        w, m = kops.prox_sgd(w, w0_flat, g, m, coeffs, out=(w_out, m),
                             engine=engine if use_kernel else "ref")
    with torch.no_grad():
        loss_after = data_loss(w, step_batch(n_steps - 1))
    return w, loss_before, loss_after
