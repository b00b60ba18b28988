"""End-to-end federated LM training entry point.

Runs real training of an ``--arch`` (any of the registry's ten) on
synthetic LM data through the federated round of :mod:`.fl_step`, on the
card by default (``--device cuda``, which raises when there is none) and
on the CPU when asked (``--device cpu``, with ``--reduced`` for the
family-preserving small variant). Counterpart of
``repro/launch/train.py``, with its flags and output.

  python -m repro_torch.launch.train --arch qwen2-1.5b              # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --device cpu \\
      --rounds 3 --clients 2 --seq 64 --per-batch 2

Flags beyond the basics:
  --aggregator {probit_plus,fedavg_fp32}  packed one-bit wire (default)
      vs the full-precision FedAvg baseline the 32x claim compares to
  --rand-bits {32,16}   quantizer draw width (16 is never on the kernels)
  --json-out PATH       write per-round metrics + wire-byte report JSON
  --smoke               exit nonzero unless every round's losses are
      finite and the wire-byte report is nonzero (CI gate)
  --remat               checkpoint each pattern unit of the local step (the
      reference's default; a memory lever that costs one more forward a
      step, off by default: the card's cells fit without it)
  --production-mesh     the reference's 16 x 16 ("data", "model") mesh over
      a world of 256 ranks (start them with torchrun): the parameters are
      DTensors, FSDP over "data" and tensor and expert parallelism over
      "model"; on any other world the mesh raises, naming the size
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .. import configs, prng
from ..checkpoint import save_checkpoint
from ..core import build_pipeline
from ..data import make_lm_streams
from ..fl.pytree_wire import pytree_wire_bytes
from ..models import build_specs
from ..models.config import ModelConfig
from ..models.spec import count_params, init_params
from .. import distributed
from .fl_step import DistFLConfig, make_fl_train_step
from .mesh import make_production_mesh

__all__ = ["parse_args", "LMRun", "setup", "round_batch", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Federated LM training through the one-bit wire.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--per-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--lam", type=float, default=0.2)
    ap.add_argument("--b-init", type=float, default=0.01)
    ap.add_argument("--aggregator", default="probit_plus", choices=["probit_plus", "fedavg_fp32"])
    ap.add_argument("--rand-bits", type=int, default=32, choices=[16, 32])
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


@dataclasses.dataclass
class LMRun:
    """What a training run holds: the config, the model's parameters on the
    device, the round function, the wire report and the clients' token
    streams."""

    cfg: ModelConfig
    device: torch.device
    params: dict
    step: object
    fl: DistFLConfig
    wire: dict
    streams: list
    mesh: object = None


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the trainer runs on the card unless --device cpu is given")
    return dev


def setup(args: argparse.Namespace, cfg: ModelConfig | None = None, mesh=None) -> LMRun:
    """The run of ``args``: parameters from ``init_params`` at key 0 on the
    device, the step, the exact per-round uplink report and
    ``make_lm_streams(0, ...)``. ``cfg``, when given, replaces the
    ``--arch`` / ``--reduced`` config (a caller's own cut, e.g. fewer
    layers at the published widths). With a ``mesh`` (a ("data", "model")
    ``DeviceMesh``; ``--production-mesh`` makes the production one) the
    parameters are DTensors on it, FSDP over "data"; run the step with the
    mesh current (``distributed.set_mesh(run.mesh)``)."""
    dev = _device(args.device)
    if mesh is None and args.production_mesh:
        mesh = make_production_mesh(device_type=dev.type)
    if cfg is None:
        cfg = configs.get_config(args.arch)
        if args.reduced:
            cfg = configs.reduced(cfg)
    params = init_params(build_specs(cfg), prng.key(0, dev), mesh=mesh, fsdp_axis="data" if mesh is not None else None)
    fl = DistFLConfig(clients_per_round=args.clients, local_steps=args.local_steps, lr=args.lr, lam=args.lam,
                      aggregator=args.aggregator, rand_bits=args.rand_bits, remat=args.remat)
    step = make_fl_train_step(cfg, fl)
    # the exact per-round uplink: the step's packed wire, or f32 under FedAvg
    pipeline = step.pipeline if args.aggregator == "probit_plus" else build_pipeline("fedavg")
    wire = pytree_wire_bytes(pipeline, params, args.clients)
    streams = make_lm_streams(0, args.clients, cfg.vocab, args.seq + 1,
                              args.local_steps * args.per_batch * args.rounds)
    return LMRun(cfg=cfg, device=dev, params=params, step=step, fl=fl, wire=wire, streams=streams, mesh=mesh)


def round_batch(run: LMRun, args: argparse.Namespace, r: int) -> dict:
    """Round ``r``'s batch, leaves ``(clients, 1, local_steps, per_batch,
    ...)``: each client's next ``local_steps * per_batch`` sequences, tokens
    ``s[:-1]`` and labels ``s[1:]`` (the loss shifts them once more, as the
    reference's does). The frontends get the reference's stubs: a vision
    model's ``frontend_tokens`` patches of ``0.02`` before the tokens; an
    audio model ``seq`` frames of ``0.02``, all masked, labelled
    ``s[:-1] % vocab``."""
    n = args.local_steps * args.per_batch
    toks = np.stack([s[r * n : (r + 1) * n].reshape(args.local_steps, args.per_batch, args.seq + 1)
                     for s in run.streams])[:, None]
    t = torch.from_numpy(toks).to(run.device)
    batch = {"tokens": t[..., :-1], "labels": t[..., 1:]}
    cfg, lead = run.cfg, t.shape[:4]
    if cfg.frontend == "vision":
        batch["patches"] = torch.full(lead + (cfg.frontend_tokens, cfg.d_model), 0.02, dtype=torch.bfloat16,
                                      device=run.device)
    elif cfg.frontend == "audio":
        feats = torch.full(lead + (args.seq, cfg.d_model), 0.02, dtype=torch.bfloat16, device=run.device)
        batch = {"feats": feats, "labels": batch["tokens"] % cfg.vocab,
                 "mask": torch.ones(lead + (args.seq,), dtype=torch.bool, device=run.device)}
    return batch


def main(argv=None) -> int:
    args = parse_args(argv)
    run = setup(args)
    cfg = run.cfg
    print(f"{cfg.name}: {count_params(build_specs(cfg)) / 1e6:.1f}M params, device={run.device}")
    wire = run.wire
    print(
        f"uplink/round: {wire['wire_bytes'] / 1e6:.3f} MB packed "
        f"(ideal {wire['wire_bytes_ideal'] / 1e6:.3f}) vs "
        f"{wire['wire_bytes_int8'] / 1e6:.3f} MB int8 "
        f"({wire['wire_bytes_int8'] / max(wire['wire_bytes_ideal'], 1):.1f}x) / "
        f"{wire['wire_bytes_f32'] / 1e6:.3f} MB f32 ({wire['wire_bytes_f32'] / max(wire['wire_bytes_ideal'], 1):.1f}x)"
    )
    params = run.params
    b = torch.tensor(args.b_init, dtype=torch.float32, device=run.device)
    key = prng.key(1, run.device)
    history = []
    for r in range(args.rounds):
        t0 = time.time()
        batch = round_batch(run, args, r)
        key, kr = prng.split(key, 2)
        with distributed.set_mesh(run.mesh):
            params, b, metrics = run.step(params, b, batch, kr)
        history.append({
            "round": r,
            "loss_first": float(metrics["loss_first"]),
            "loss_last": float(metrics["loss_last"]),
            "b": float(b),
            "wire_bytes": float(metrics["wire_bytes"]),
            "seconds": time.time() - t0,
        })
        h = history[-1]
        print(f"round {r}: loss {h['loss_first']:.4f} -> {h['loss_last']:.4f}  b={h['b']:.5f}  "
              f"wire={h['wire_bytes'] / 1e6:.3f}MB  ({h['seconds']:.1f}s)")
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.rounds, params, {"arch": cfg.name})
        print("checkpoint:", path)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"arch": cfg.name, "aggregator": args.aggregator, "rand_bits": args.rand_bits,
                       "clients": args.clients, "device": str(run.device), "wire": wire, "rounds": history},
                      f, indent=2)
        print("json:", args.json_out)
    if args.smoke:
        finite = all(np.isfinite(h["loss_first"]) and np.isfinite(h["loss_last"]) for h in history)
        wired = all(h["wire_bytes"] > 0 for h in history) and wire["wire_bytes"] > 0
        if not (finite and wired):
            print(f"SMOKE FAIL: finite={finite} wired={wired}", file=sys.stderr)
            return 1
        print("SMOKE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
