"""Flat parameter vectors in the reference's order.

The JAX package flattens a parameter tree with ``ravel_pytree``, which
sorts dict keys at every level (the MLP: ``b1, b2, b3, w1, w2, w3``; the
ResNet: ``head_b, head_w, s0b0/b1, s0b0/b2, s0b0/c1, ..., stem``) and
ravels each leaf in C order. The port keeps the same flat order, so
coordinate ``i`` of the port's model difference is coordinate ``i`` of the
reference's, and its wire bits belong to the same weight.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch

__all__ = ["ravel_params", "params_from_jax"]


def _leaves(tree: Mapping, prefix: tuple = ()):
    """``(path, leaf)`` pairs of a nested dict, keys sorted at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def ravel_params(params: Mapping, device=None) -> tuple[torch.Tensor, Callable]:
    """Flatten a (nested) dict of arrays (numpy or torch) into one f32 (d,)
    tensor in ravel order, and return it with its ``unravel``.

    ``unravel(flat)`` takes ``(..., d)`` (a cohort of flat vectors too) and
    returns the same nesting of views shaped ``(...,) + leaf.shape``.
    """
    paths, leaves = [], []
    for path, leaf in _leaves(params):
        paths.append(path)
        leaves.append(leaf if torch.is_tensor(leaf) else torch.from_numpy(np.array(leaf, np.float32)))
    shapes = [tuple(t.shape) for t in leaves]
    flat = torch.cat([t.reshape(-1).to(device=device, dtype=torch.float32) for t in leaves])
    sizes = [math.prod(s) for s in shapes]

    def unravel(vec: torch.Tensor) -> dict:
        lead = vec.shape[:-1]
        out: dict = {}
        for path, part, shape in zip(paths, torch.split(vec, sizes, dim=-1), shapes):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = part.reshape(lead + shape)
        return out

    return flat, unravel


def params_from_jax(tree: Mapping, device=None) -> torch.Tensor:
    """The flat torch vector of a JAX parameter tree (passed as numpy
    arrays), in the order of the reference's ``ravel_pytree``."""
    return ravel_params(tree, device)[0]
