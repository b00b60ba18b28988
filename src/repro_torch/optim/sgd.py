"""The prox-regularized local solver (paper Eq. 4), batched over clients.

Counterpart of ``repro/optim/sgd.py: local_prox_train``. Clients minimize
``f_m(w) + (lam/2) ||w - w_g||^2`` with momentum SGD. The reference vmaps
one client's ``lax.scan``; here the whole cohort steps together: each local
step takes one autograd gradient for all M clients (their losses are
independent, so the gradient of their sum is every client's own) and one
fused prox step on the ``(M, d)`` cohort through ``ops.prox_sgd``: with
``use_kernel`` one launch of the ``prox_sgd`` kernel on a CUDA tensor,
without it the plain version (``engine="ref"``) on any device. The step
updates the cohort's weights and momentum in place (JAX returns new
arrays; the values are the same), and never writes into ``w_init``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import ops as kops

__all__ = ["local_prox_train"]


def local_prox_train(
    loss_fn: Callable,
    w0_flat: torch.Tensor,
    w_init: torch.Tensor,
    unravel: Callable,
    batches: dict,
    *,
    lr: float,
    mu: float,
    lam: float,
    use_kernel: bool = False,
    engine: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the local steps of every client over pre-drawn batches.

    ``w0_flat`` (d,) is the global model, ``w_init`` (M, d) the clients'
    starting points, ``batches`` leaves ``(M, n_steps, batch, ...)``;
    ``loss_fn(params, batch)`` returns one loss per client. Returns
    ``(w_final (M, d), loss_first (M,), loss_last (M,))``: the loss before
    training on the first batch and after it on the last, the two values
    the dynamic-b controller's loss bit compares.
    """
    n_steps = next(iter(batches.values())).shape[1]

    def step_batch(s):
        return {k: v[:, s] for k, v in batches.items()}

    def data_loss(w, batch):
        return loss_fn(unravel(w), batch)

    with torch.no_grad():
        loss_before = data_loss(w_init, step_batch(0))
    w = w_init
    m = torch.zeros_like(w_init)
    for s in range(n_steps):
        wg = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(data_loss(wg, step_batch(s)).sum(), wg)
        # in place from step 1 on; step 0 writes a fresh buffer, since the
        # caller still holds w_init
        w_out = w if s else torch.empty_like(w_init)
        w, m = kops.prox_sgd(w, w0_flat, g, m, lr, lam, mu, out=(w_out, m),
                             engine=engine if use_kernel else "ref")
    with torch.no_grad():
        loss_after = data_loss(w, step_batch(n_steps - 1))
    return w, loss_before, loss_after
