"""Batched decode engine over the model zoo's ``serve_step``.

Counterpart of ``repro/serving/engine.py``: it serves the FL-aggregated
global model with the reference's static-batch schedule. Prompts come in
waves of ``batch_size``, left-aligned in the batch, with one position
``t`` shared by every slot; each prompt is fed one token at a time
through ``serve_step`` (so attention KV caches, ring windows and the
recurrent states of the SSM and xLSTM mixers are served alike), a slot
starts emitting at ``t >= len(prompt) - 1``, and the caches are made anew
for every wave. Decoding is greedy (``argmax``, ties to the first index,
as ``jnp.argmax``) or samples at a temperature as
``jax.random.categorical(ks, logits / T)`` does under ``jit``:
``argmax(logits * f32(1/T) + gumbel)``, the gumbel drawn from the port's
Threefry, so the same seed gives the reference's tokens.

The engine runs where the parameters are: on the card for the card's
parameters, on the CPU for the CPU's (the tests). It moves nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from .. import prng
from ..core.aggregation import recip32
from ..models import init_cache, serve_step
from ..models.config import ModelConfig
from ..tree import leaves

__all__ = ["ServeConfig", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 8
    max_len: int = 256  # cache length
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    window: int = 0  # >0: ring-buffer sliding window
    eos_token: int = -1  # -1: disabled


class ServingEngine:
    """``generate(prompts, seed)`` decodes a list of prompts. ``steps``
    counts the decode steps (``serve_step`` calls of the whole batch) of the
    last ``generate``."""

    def __init__(self, cfg: ModelConfig, params, serve: ServeConfig):
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: it has no decode path")
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.device = leaves(params)[0].device
        self.cache = init_cache(cfg, serve.batch_size, serve.max_len, self.device)
        self.steps = 0

    def step(self, tokens: torch.Tensor, pos: int, key: torch.Tensor) -> torch.Tensor:
        """One decode step of the batch: ``tokens`` (B, 1) at ``pos``; the
        next token of every slot, (B,) on the device."""
        s = self.serve
        logits, self.cache = serve_step(self.params, self.cache, {"tokens": tokens}, pos, self.cfg, s.window)
        if s.temperature > 0:
            return prng.categorical(key, logits * recip32(s.temperature))
        return torch.argmax(logits, dim=-1)

    def generate(self, prompts: Iterable[list[int]], seed: int = 0) -> list[list[int]]:
        """Decode a list of prompts (static batch; queue refill between
        waves). Returns the generated token lists (prompts excluded)."""
        prompts = [list(p) for p in prompts]
        s = self.serve
        results: list[list[int]] = [[] for _ in prompts]
        key = prng.key(seed, self.device)
        queue = list(range(len(prompts)))
        self.steps = 0
        while queue:
            wave, queue = queue[: s.batch_size], queue[s.batch_size :]
            maxp = max(len(prompts[i]) for i in wave)
            if s.window <= 0 and maxp + s.max_new_tokens - 1 > s.max_len:
                # the reference's cache write would clamp to the last slot
                raise ValueError(f"a wave needs {maxp + s.max_new_tokens - 1} positions; the cache has {s.max_len}")
            self.cache = init_cache(self.cfg, s.batch_size, s.max_len, self.device)
            done = np.arange(s.batch_size) >= len(wave)
            cur = np.zeros((s.batch_size, 1), np.int64)
            for t in range(maxp + s.max_new_tokens - 1):
                for bi, ri in enumerate(wave):
                    if t < len(prompts[ri]):
                        cur[bi, 0] = prompts[ri][t]
                key, ks = prng.split(key, 2)
                nxt = self.step(torch.from_numpy(cur).to(self.device), t, ks).cpu().numpy()
                self.steps += 1
                for bi, ri in enumerate(wave):
                    if t >= len(prompts[ri]) - 1 and not done[bi]:
                        tok = int(nxt[bi])
                        results[ri].append(tok)
                        if tok == s.eos_token or len(results[ri]) >= s.max_new_tokens:
                            done[bi] = True
                        else:
                            cur[bi, 0] = tok
                if done[: len(wave)].all():
                    break
        return results
