"""Model inputs: the structure of one step's batch, meta-tensor stand-ins
for the dry run (nothing allocated), and concrete random batches for
smoke tests.

Counterpart of ``repro/models/inputs.py``. For the audio and vision
architectures the frontend is a stub, as in the reference: the batch
carries precomputed frame or patch embeddings.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig

__all__ = ["batch_structure", "input_specs", "input_logical", "sample_batch"]


def batch_structure(cfg: ModelConfig, batch: int, seq: int, kind: str) -> dict:
    """Returns {name: (shape, dtype, logical)} for one step's model inputs."""
    if kind == "decode":
        return {"tokens": ((batch, 1), torch.int32, ("batch", None))}
    if cfg.frontend == "audio":
        return {
            "feats": ((batch, seq, cfg.d_model), torch.bfloat16, ("batch", None, None)),
            "labels": ((batch, seq), torch.int32, ("batch", None)),
            "mask": ((batch, seq), torch.bool, ("batch", None)),
        }
    if cfg.frontend == "vision":
        p = cfg.frontend_tokens
        text = seq - p
        if text <= 0:
            raise ValueError(f"seq {seq} leaves no text after {p} patch tokens")
        d: dict = {
            "patches": ((batch, p, cfg.d_model), torch.bfloat16, ("batch", None, None)),
            "tokens": ((batch, text), torch.int32, ("batch", None)),
        }
        if kind == "train":
            d["labels"] = ((batch, text), torch.int32, ("batch", None))
        return d
    d = {"tokens": ((batch, seq), torch.int32, ("batch", None))}
    if kind == "train":
        d["labels"] = ((batch, seq), torch.int32, ("batch", None))
    return d


def input_specs(cfg: ModelConfig, batch: int, seq: int, kind: str) -> dict:
    """Meta tensors of one step's inputs (nothing allocated)."""
    return {k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype, _) in batch_structure(cfg, batch, seq, kind).items()}


def input_logical(cfg: ModelConfig, batch: int, seq: int, kind: str) -> dict:
    """The logical axes of each input."""
    return {k: logical for k, (_, __, logical) in batch_structure(cfg, batch, seq, kind).items()}


def sample_batch(cfg: ModelConfig, batch: int, seq: int, kind: str, seed: int = 0, device=None) -> dict:
    """Concrete random batch, the reference's draws from
    ``numpy.random.default_rng(seed)`` in the same order."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype, _) in batch_structure(cfg, batch, seq, kind).items():
        if dtype == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels") else 2
            arr = torch.from_numpy(rng.integers(0, hi, size=shape).astype(np.int32))
        elif dtype == torch.bool:
            arr = torch.from_numpy(rng.random(shape) < 0.3)
        else:
            arr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        out[k] = arr.to(device)
    return out
