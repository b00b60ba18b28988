"""Byzantine-attack demo (paper §VI-D): 30% malicious clients launch each
of four attacks; PRoBit+ against FedAvg and signSGD-MV (the port's
``examples/byzantine_robustness.py``).

Run:  python -m repro_torch.examples.byzantine_robustness [--rounds 60] [--device cuda|cpu]
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

ATTACKS = ("gaussian", "sign_flip", "zero_gradient", "sample_duplicate")
SERVERS = ("probit_plus", "fedavg", "signsgd_mv")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=3000, n_test=600)
    m = 10
    parts = partition_label_skew(ytr, m, 2, 100)
    cx = np.stack([xtr[i] for i in parts])
    cy = np.stack([ytr[i] for i in parts])
    loss_fn = functools.partial(xent_loss, mlp_logits)
    acc_fn = functools.partial(accuracy, mlp_logits)
    p0 = init_mlp(prng.key(0), hidden=48)
    print(f"device: {device_name(dev)}")
    print(f"{'attack':<18} {'PRoBit+':>8} {'FedAvg':>8} {'signSGD-MV':>11}")
    out = {}
    for attack in ATTACKS:
        row = []
        for agg in SERVERS:
            cfg = FLConfig(n_clients=m, aggregator=agg, rounds=args.rounds, local_epochs=2, byz_frac=0.3,
                           attack=attack, b_mode="fixed")
            sim = FLSimulation(cfg, p0, loss_fn, acc_fn, cx, cy, {"x": xte, "y": yte}, device=dev)
            sim.run(eval_every=args.rounds)
            row.append(sim.history[-1]["acc"])
        out[attack] = dict(zip(SERVERS, row))
        print(f"{attack:<18} {row[0]:>8.3f} {row[1]:>8.3f} {row[2]:>11.3f}")
    return out


if __name__ == "__main__":
    main()
