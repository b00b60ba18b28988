"""Serve a small model with batched requests: after federated training
aggregates a global model, deploy it behind the batched decode engine
(greedy or sampled, ring window optional). The port's
``examples/serve_llm.py``: the reduced qwen2, 6 prompts over a batch of 4.

Run:  python -m repro_torch.examples.serve_llm [--temperature 0.8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import configs, prng
from ..models import build_specs
from ..models.spec import init_params
from ..serving import ServeConfig, ServingEngine
from . import device, device_arg, device_name

PROMPT_LENS = (5, 9, 3, 7, 6, 4)  # 6 requests > batch 4


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--window", type=int, default=0)
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    cfg = configs.reduced(configs.get_config("qwen2-1.5b"))
    params = init_params(build_specs(cfg), prng.key(0, dev))
    engine = ServingEngine(cfg, params, ServeConfig(batch_size=4, max_len=64, max_new_tokens=args.max_new_tokens,
                                                    temperature=args.temperature, window=args.window))
    rng = prng.key(7)
    prompts = [prng.randint(prng.fold_in(rng, i), (n,), 0, cfg.vocab).tolist() for i, n in enumerate(PROMPT_LENS)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in out)
    for i, o in enumerate(out):
        print(f"req{i} ({len(prompts[i])} prompt toks) -> {len(o)} generated: {o[:8]}...")
    print(f"\n{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s batched, {engine.steps} steps, {device_name(dev)})")
    return out


if __name__ == "__main__":
    main()
