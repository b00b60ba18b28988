"""Flat parameter vectors in the reference's order.

The JAX package flattens a parameter dict with ``ravel_pytree``, which
sorts dict keys (the MLP: ``b1, b2, b3, w1, w2, w3``) and ravels each leaf
in C order. The port keeps the same flat order, so coordinate ``i`` of the
port's model difference is coordinate ``i`` of the reference's, and its
wire bits belong to the same weight.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch

__all__ = ["ravel_params", "params_from_jax"]


def ravel_params(params: Mapping, device=None) -> tuple[torch.Tensor, Callable]:
    """Flatten a flat dict of arrays (numpy or torch) into one f32 (d,)
    tensor in ravel order, and return it with its ``unravel``.

    ``unravel(flat)`` takes ``(..., d)`` (a cohort of flat vectors too) and
    returns a dict of views shaped ``(...,) + leaf.shape``.
    """
    names = sorted(params)
    leaves = [params[k] if torch.is_tensor(params[k]) else torch.from_numpy(np.array(params[k], np.float32))
              for k in names]
    shapes = [tuple(t.shape) for t in leaves]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves]).to(device)
    sizes = [math.prod(s) for s in shapes]

    def unravel(vec: torch.Tensor) -> dict:
        lead = vec.shape[:-1]
        parts = torch.split(vec, sizes, dim=-1)
        return {k: p.reshape(lead + s) for k, p, s in zip(names, parts, shapes)}

    return flat, unravel


def params_from_jax(tree: Mapping, device=None) -> torch.Tensor:
    """The flat torch vector of a JAX parameter dict (passed as numpy
    arrays), in the order of the reference's ``ravel_pytree``."""
    return ravel_params(tree, device)[0]
