"""Differentially private federated fine-tuning of a transformer LM (the
port's ``examples/private_federated_lm.py``).

The same ``FLSimulation`` round that trains the MLP drives a transformer of
the model zoo (the reduced qwen2, in f32), with (eps, 0)-local DP enforced
by the quantizer's b-floor (Theorem 3). The round hands ``loss_fn`` the
cohort's parameter trees, every leaf with a leading client axis, and the
cohort's token rows (as f32, like every client batch), so the loss takes
one client at a time.

Run:  python -m repro_torch.examples.private_federated_lm [--rounds 8] [--eps 0 0.1 0.01] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import configs, prng
from ..data import make_lm_streams
from ..fl import FLConfig, FLSimulation
from ..models import build_specs, train_loss
from ..models.spec import init_params
from ..tree import tree_map
from . import device, device_arg, device_name


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--eps", type=float, nargs="+", default=[0.0, 0.1, 0.01], help="the DP budgets, one run each")
    device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    cfg = configs.reduced(configs.get_config("qwen2-1.5b"))
    params0 = tree_map(lambda a: a.float(), init_params(build_specs(cfg), prng.key(0)))

    m, seq, per_client = 6, 48, 24
    cx = np.stack(make_lm_streams(0, m, cfg.vocab, seq + 1, per_client))  # (M, per_client, seq+1)
    cy = cx[..., 0]  # unused placeholder labels for the runtime API

    def lm_loss(params, toks):
        toks = toks.long()
        return train_loss(params, {"tokens": toks[..., :-1], "labels": toks[..., 1:]}, cfg)

    def loss_fn(params, batch):
        """One loss a client of the cohort."""
        return torch.stack([lm_loss(tree_map(lambda a: a[i], params), x) for i, x in enumerate(batch["x"])])

    def ppl_metric(params, batch):
        return -lm_loss(params, batch["x"])  # higher is better

    test = {"x": cx[:, :4].reshape(-1, seq + 1), "y": cy[:, :4].reshape(-1)}
    print(f"device: {device_name(dev)}")
    # Half the cohort participates in a round: the subsampled accountant
    # (FLConfig.dp_accountant's default) prices each round at the amplified
    # ln(1 + q(e^eps - 1)) < eps, so the cumulative eps_spent is strictly
    # below the conservative eps * rounds.
    out = {}
    for eps in args.eps:
        fl = FLConfig(n_clients=m, aggregator="probit_plus", rounds=args.rounds, local_epochs=1, batch_size=4,
                      dp_epsilon=eps, participation=0.5)
        sim = FLSimulation(fl, params0, loss_fn, ppl_metric, cx, cy, test, device=dev)
        sim.run(eval_every=args.rounds)
        tag = "no DP" if eps == 0 else f"eps={eps}"
        h = sim.history[-1]
        spent, conservative = sim.ledger.eps_spent, sim.ledger.compose("basic")[0]
        out[tag] = {"nll": -h["acc"], "b": h["b"], "eps_spent": spent, "eps_basic": conservative}
        print(f"{tag:>9}: final test NLL {-h['acc']:.4f} (b={h['b']:.4f}, "
              f"eps_spent={spent:.4f} vs basic {conservative:.4f})")
    return out


if __name__ == "__main__":
    main()
