"""Dependency-free checkpoints of parameter trees, in the reference's format.

Counterpart of ``repro/checkpoint/io.py``: one ``ckpt_<step>.npz`` a step
(one array a leaf, named by the reference's key, ``['blocks']/[0]/['ffn']/['w1']``
from :func:`repro_torch.tree.keystr`) and a JSON of metadata beside it.
bf16 leaves are widened to f32 (npz has no bf16; the widening is exact)
and rounded back to nearest even on load, as JAX rounds, so a checkpoint
that either package writes loads into the other.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from ..tree import keystr, leaves_with_path, unflatten

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {keystr(path): _to_numpy(leaf) for path, leaf in leaves_with_path(tree)}


def save_checkpoint(directory: str, step: int, tree, metadata: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    flat = _flatten(tree)
    np.savez_compressed(path, **flat)
    meta = {"step": step, "keys": sorted(flat), **(metadata or {})}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory) if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, like):
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf's shape is checked and it takes ``like``'s dtype and device."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    restored = []
    with np.load(path) as data:
        for p, leaf in leaves_with_path(like):
            key = keystr(p)
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != {tuple(leaf.shape)}")
            restored.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device=leaf.device, dtype=leaf.dtype))
    return unflatten(like, restored)
