"""Top-k sparse PRoBit+ (the paper's future work, "partial network updates").

Counterpart of ``repro/core/sparse.py``. Each client uploads Eq.-5 bits for
the ``k`` coordinates of largest ``|delta|`` and their indices (the
:class:`~repro_torch.core.aggregation.SparseWire`); the server estimates
each coordinate from the clients that reported it::

    theta_hat_i = (2 N_i - M_i) / M_i * b_i     (M_i = clients reporting i)

and leaves unreported coordinates at 0.

The selection is the reference's ``jax.lax.top_k``: indices by descending
magnitude, and among equal magnitudes (exact zeros are common) the lower
index first, which is a stable descending sort (``torch.topk`` promises no
order among ties). The runtime refuses top-k under DP: a data-dependent
index set breaks the bit mechanism's (eps, 0) guarantee.
"""

from __future__ import annotations

import torch

from .. import prng
from .quantizer import binarize_prob

__all__ = ["topk_indices", "topk_binarize", "sparse_aggregate"]


def topk_indices(delta: torch.Tensor, k: int) -> torch.Tensor:
    """int64 indices of the ``k`` largest ``|delta|`` along the last axis,
    in ``jax.lax.top_k``'s order: descending, ties by ascending index."""
    return torch.sort(delta.abs(), dim=-1, descending=True, stable=True).indices[..., :k]


def topk_binarize(key: torch.Tensor, delta: torch.Tensor, b: torch.Tensor, k: int):
    """(indices (k,) int32, codes (k,) int8 in {-1, +1}) of one client: the
    top-k coordinates binarized by Eq. 5 with ``uniform(key, (k,))``. Keys
    (M, 2) and deltas (M, d) give (M, k) of each, one row a client."""
    idx = topk_indices(delta, k)
    d_sel = delta.gather(-1, idx)
    b_sel = torch.broadcast_to(b, delta.shape).gather(-1, idx)
    bits = prng.uniform(key, (k,)) < binarize_prob(d_sel, b_sel)
    return idx.to(torch.int32), bits.to(torch.int8) * 2 - 1


def sparse_aggregate(indices: torch.Tensor, codes: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """indices/codes (M, k) -> theta_hat (d,): per coordinate, the Eq.-13
    estimate over the clients that reported it (a true division by their
    count, as in the reference), 0 where none did. The counts are integers
    (one ``bincount`` over minus and plus votes), so their order of
    accumulation cannot change them."""
    idx = indices.reshape(-1).long()
    votes = torch.bincount(idx + d * (codes.reshape(-1) > 0).long(), minlength=2 * d).float()
    plus, count = votes[d:], votes[:d] + votes[d:]
    theta = (2.0 * plus - count) / torch.clamp(count, min=1.0) * torch.broadcast_to(b, (d,))
    return torch.where(count > 0, theta, torch.zeros_like(theta))
