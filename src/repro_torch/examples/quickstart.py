"""Quickstart: PRoBit+ against full-precision FedAvg on a heterogeneous FL
task (the port's ``examples/quickstart.py``).

Run:  python -m repro_torch.examples.quickstart [--rounds 100] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np

from .. import prng
from ..data import make_classification, partition_label_skew
from ..fl import FLConfig, FLSimulation
from ..models.vision import accuracy, init_mlp, mlp_logits, xent_loss
from . import device, device_arg, device_name


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=20)
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    # 1. a 10-class task, each client holding only 2 classes (paper §VI-A)
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=4000, n_test=800)
    m = args.clients
    parts = partition_label_skew(ytr, m, classes_per_client=2, per_client=100)
    cx = np.stack([xtr[i] for i in parts])
    cy = np.stack([ytr[i] for i in parts])
    loss_fn = functools.partial(xent_loss, mlp_logits)
    acc_fn = functools.partial(accuracy, mlp_logits)
    p0 = init_mlp(prng.key(0), hidden=64)
    print(f"device: {device_name(dev)}")
    # 2. both aggregators with the identical protocol
    out = {}
    for agg in ("fedavg", "probit_plus"):
        cfg = FLConfig(n_clients=m, aggregator=agg, rounds=args.rounds, local_epochs=2)
        sim = FLSimulation(cfg, p0, loss_fn, acc_fn, cx, cy, {"x": xte, "y": yte}, device=dev)
        sim.run(eval_every=25, verbose=True)
        bits = 1 if agg == "probit_plus" else 32
        out[agg] = sim.history[-1]["acc"]
        print(f"--> {agg}: final acc {out[agg]:.3f} (uplink: {bits} bit/param/round)\n")
    return out


if __name__ == "__main__":
    main()
