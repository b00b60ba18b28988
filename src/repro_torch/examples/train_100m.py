"""End-to-end run: federated fine-tuning of a transformer LM through the
packed one-bit pytree wire, with a FedAvg full-precision baseline (the
port's ``examples/train_100m.py``, through ``launch/fl_step.py``; one card
needs none of the reference's mesh set-up).

The default is a ~6M qwen2 for a quick demonstration; ``--full`` is the
~100M-parameter qwen2 variant and 300 rounds. Every round reports the
uplink wire bytes of the packed one-bit wire beside the int8 (8x) and f32
(32x) baselines; after training, next-token accuracy on held-out client
streams for both the PRoBit+ run and the FedAvg run (same data, init and
round budget). The PRoBit+ parameters are checkpointed; ``--json-out``
writes the whole report.

Run:  python -m repro_torch.examples.train_100m [--full] [--rounds N] [--json-out report.json] \\
          [--skip-fedavg] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import configs, prng
from ..checkpoint import save_checkpoint
from ..core import build_pipeline
from ..data import make_lm_streams
from ..fl.pytree_wire import pytree_wire_bytes
from ..launch.fl_step import DistFLConfig, make_fl_train_step
from ..models import build_specs, prefill
from ..models.config import ModelConfig
from ..models.spec import count_params, init_params
from . import device, device_arg, device_name


def model_config(full: bool) -> ModelConfig:
    if full:  # ~100M-parameter qwen2-family model
        return dataclasses.replace(configs.get_config("qwen2-1.5b"), name="qwen2-100m", n_layers=8, d_model=640,
                                   n_heads=10, n_kv_heads=2, d_ff=1792, vocab=32768, d_head=64)
    return dataclasses.replace(configs.get_config("qwen2-1.5b"), name="qwen2-6m", n_layers=4, d_model=192,
                               n_heads=6, n_kv_heads=2, d_ff=512, vocab=4096, d_head=32)


@torch.no_grad()
def next_token_accuracy(params, cfg, tokens, labels, batch_size=8) -> float:
    """Mean next-token top-1 accuracy under the training objective's shift
    and mask (``train_loss``: labels rolled by -1, last position masked)."""
    correct = total = 0
    for i in range(0, tokens.shape[0], batch_size):
        tb, lb = tokens[i : i + batch_size], labels[i : i + batch_size]
        pred = prefill(params, {"tokens": tb}, cfg).argmax(-1)
        hit = (pred == torch.roll(lb, -1, dims=1))[:, :-1]  # the last position has no next token
        correct += int(hit.sum())
        total += hit.numel()
    return correct / max(total, 1)


def run_training(cfg, fl, params, rounds, seq, streams, report_every, dev):
    """One federated run from ``params`` (left as they are): returns the
    new parameters and the per-round history."""
    step = make_fl_train_step(cfg, fl)
    b = torch.tensor(0.01, dtype=torch.float32, device=dev)
    key = prng.key(1, dev)
    history = []
    t0 = time.perf_counter()
    for r in range(rounds):
        toks = np.stack([s[4 * r : 4 * (r + 1)].reshape(2, 2, seq + 1) for s in streams])[:, None]
        t = torch.from_numpy(toks).to(dev)
        key, kr = prng.split(key, 2)
        params, b, metrics = step(params, b, {"tokens": t[..., :-1], "labels": t[..., 1:]}, kr)
        history.append({"round": r, "loss_first": float(metrics["loss_first"]),
                        "loss_last": float(metrics["loss_last"]), "b": float(b),
                        "wire_bytes": float(metrics["wire_bytes"])})
        h = history[-1]
        if r % report_every == 0 or r == rounds - 1:
            print(f"  [{fl.aggregator}] round {r:4d}: loss {h['loss_first']:.4f} -> {h['loss_last']:.4f}  "
                  f"b={h['b']:.5f}  wire={h['wire_bytes'] / 1e6:.3f}MB  [{time.perf_counter() - t0:.0f}s]")
    return params, history


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eval-seqs", type=int, default=32)
    ap.add_argument("--skip-fedavg", action="store_true")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "probit_ckpts"),
                    help="'' to skip the checkpoint")
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    rounds = args.rounds or (300 if args.full else 30)

    cfg = model_config(args.full)
    specs = build_specs(cfg)
    print(f"{cfg.name}: {count_params(specs) / 1e6:.1f}M params, {rounds} rounds, {device_name(dev)}")
    params0 = init_params(specs, prng.key(0, dev))  # both runs start here
    wire = pytree_wire_bytes(build_pipeline("probit_plus"), params0, args.clients)
    print(f"uplink/round ({args.clients} clients): {wire['wire_bytes'] / 1e6:.3f} MB packed "
          f"(ideal {wire['wire_bytes_ideal'] / 1e6:.3f}) - "
          f"{wire['wire_bytes_int8'] / max(wire['wire_bytes_ideal'], 1):.1f}x smaller than int8, "
          f"{wire['wire_bytes_f32'] / max(wire['wire_bytes_ideal'], 1):.1f}x smaller than f32")

    # training and held-out streams (held out: fresh sequences from the same
    # per-client bigram models, another seed)
    streams = make_lm_streams(0, args.clients, cfg.vocab, args.seq + 1, 4 * rounds)
    ev = torch.from_numpy(np.concatenate(make_lm_streams(7, args.clients, cfg.vocab, args.seq + 1,
                                                         args.eval_seqs))).to(dev)
    ev_toks, ev_labels = ev[:, :-1], ev[:, 1:]

    report_every = max(rounds // 10, 1)
    fl = DistFLConfig(clients_per_round=args.clients, local_steps=2, lr=0.02)
    print("training: PRoBit+ (packed one-bit wire)")
    params, hist = run_training(cfg, fl, params0, rounds, args.seq, streams, report_every, dev)
    acc = next_token_accuracy(params, cfg, ev_toks, ev_labels)
    print(f"PRoBit+ next-token accuracy: {acc:.4f}")
    result = {"arch": cfg.name, "device": device_name(dev), "rounds": rounds, "clients": args.clients, "wire": wire,
              "probit_plus": {"history": hist, "accuracy": acc}}

    if not args.skip_fedavg:
        print("training: FedAvg fp32 baseline (same data, init, budget)")
        params_avg, hist_avg = run_training(cfg, dataclasses.replace(fl, aggregator="fedavg_fp32"), params0, rounds,
                                            args.seq, streams, report_every, dev)
        acc_avg = next_token_accuracy(params_avg, cfg, ev_toks, ev_labels)
        print(f"FedAvg next-token accuracy:  {acc_avg:.4f}  (PRoBit+ {acc:.4f} at "
              f"{wire['wire_bytes_f32'] / max(wire['wire_bytes'], 1):.1f}x less uplink)")
        result["fedavg"] = {"history": hist_avg, "accuracy": acc_avg}
        result["acc_vs_fedavg"] = acc - acc_avg

    if args.ckpt_dir:
        print("saved:", save_checkpoint(args.ckpt_dir, rounds, params, {"arch": cfg.name}))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)
        print("json:", args.json_out)
    return result


if __name__ == "__main__":
    main()
