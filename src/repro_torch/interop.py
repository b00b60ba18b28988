"""Flat parameter vectors and parameter trees in the reference's order.

The JAX package flattens a parameter tree with ``ravel_pytree`` /
``tree_flatten``, which sort dict keys at every level and keep list items
in order (the MLP: ``b1, b2, b3, w1, w2, w3``; the ResNet: ``head_b,
head_w, s0b0/b1, s0b0/b2, s0b0/c1, ..., stem``; a transformer:
``blocks/0/ffn/w1, ..., embed/embed, embed/head, final_norm/w``) and ravel
each leaf in C order. The port keeps the same flat order
(:mod:`repro_torch.tree`), so coordinate ``i`` of the port's model
difference is coordinate ``i`` of the reference's, and its wire bits
belong to the same weight.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["ravel_params", "params_from_jax", "lm_params_from_numpy", "lm_cache_from_numpy"]


def _leaves(tree, prefix: tuple = ()):
    """``(path, leaf)`` pairs of a nested dict / list tree in flatten order."""
    yield from leaves_with_path(tree, prefix=prefix)


def ravel_params(params, device=None) -> tuple[torch.Tensor, Callable]:
    """Flatten a tree of arrays (numpy or torch; nested dicts and lists) into
    one f32 (d,) tensor in ravel order, and return it with its ``unravel``.

    ``unravel(flat)`` takes ``(..., d)`` (a cohort of flat vectors too) and
    returns the same nesting of views shaped ``(...,) + leaf.shape``.
    """
    leaves = [leaf if torch.is_tensor(leaf) else torch.from_numpy(np.array(leaf, np.float32))
              for _, leaf in _leaves(params)]
    shapes = [tuple(t.shape) for t in leaves]
    flat = torch.cat([t.reshape(-1).to(device=device, dtype=torch.float32) for t in leaves])
    sizes = [math.prod(s) for s in shapes]

    def unravel(vec: torch.Tensor):
        lead = vec.shape[:-1]
        parts = [part.reshape(lead + shape) for part, shape in zip(torch.split(vec, sizes, dim=-1), shapes)]
        return unflatten(params, parts)

    return flat, unravel


def params_from_jax(tree, device=None) -> torch.Tensor:
    """The flat torch vector of a JAX parameter tree (passed as numpy
    arrays), in the order of the reference's ``ravel_pytree``."""
    return ravel_params(tree, device)[0]


def lm_params_from_numpy(tree, device=None, dtype=torch.bfloat16, specs=None):
    """A JAX parameter tree, passed as numpy arrays, as the port's tree of
    tensors on ``device``: each leaf of ``dtype``, or, given the model's
    ``specs`` (``models.build_specs``), of its spec's dtype (the MoE
    router is f32 in a bf16 tree). A bf16 tree arrives widened to f32 (a
    lossless widening: numpy has no bf16 without ``ml_dtypes``), and the
    cast back rounds to nearest even, as JAX's does, so it is exact."""

    def carry(a, leaf_dtype):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device=device, dtype=leaf_dtype)

    if specs is None:
        return tree_map(lambda a: carry(a, dtype), tree)
    spec_dtypes = [s.dtype for s in leaves(specs, is_leaf=lambda s: hasattr(s, "logical"))]
    return unflatten(tree, [carry(a, t) for a, t in zip(leaves(tree), spec_dtypes, strict=True)])


def lm_cache_from_numpy(cache, device=None):
    """A JAX decode cache (``models.init_cache``'s tree, as returned by
    ``serve_step``), passed as numpy arrays, as the port's cache on
    ``device``: a leaf whose numpy dtype is bfloat16 (what ``np.asarray``
    makes of a bf16 JAX array) becomes a bf16 tensor, any other a tensor of
    its own dtype. Each leaf is a copy the port's steps may update in place."""

    def carry(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
        return torch.from_numpy(a.copy()).to(device=device)

    return tree_map(carry, cache)
