"""A/B of one client's forward and backward of the LM round on the card.

Runs ``launch/fl_step.py: _value_and_grad`` (the model's loss and its
gradient with respect to every leaf, as the LM round calls it) on one
client's batch of BATCH sequences of an architecture at its published
widths, with the ``repro_torch`` package found under ``--src``, so that a
parent and a change are compared on one card in one command: unpack the
parent (``git archive``) into a directory that ``.gitignore`` lists and
run the script for each, in the order parent, change, change, parent.
Prints one JSON line: the stream ms of each of REPS timed calls (CUDA
events around the call, after WARMUP untimed calls), their median, the
peak memory and the card.

  for s in build/parent/src src src build/parent/src; do
    python tools/lm_backward_ms.py --src $s --arch pixtral-12b --layers 2 --seq 2048; done

(``--seq`` counts a frontend's stub positions: pixtral-12b's 1,024
patches and 1,024 text tokens make 2,048.)
"""

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

BATCH, WARMUP, REPS = 2, 2, 5  # the LM round's --per-batch; untimed and timed calls


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src", help="directory that holds the repro_torch package to time")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=0, help="cut the model to this many layers (0: all)")
    ap.add_argument("--seq", type=int, default=128, help="tokens a sequence")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    from repro_torch import configs, prng, tree
    from repro_torch.launch import fl_step
    from repro_torch.models import build_specs, init_params, sample_batch

    dev = torch.device("cuda")
    cfg = configs.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    t0 = time.perf_counter()
    params = init_params(build_specs(cfg), prng.key(0, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: v.to(dev) for k, v in sample_batch(cfg, BATCH, args.seq, "train", seed=1).items()}
    leaves = tree.leaves(params)
    ms = []
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(WARMUP + REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        _, grads = fl_step._value_and_grad(leaves, params, batch, cfg)
        b.record()
        torch.cuda.synchronize()
        del grads
        if i >= WARMUP:
            ms.append(a.elapsed_time(b))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"src": args.src, "arch": args.arch, "layers": cfg.n_layers, "reps": cfg.reps,
                      "batch": [BATCH, args.seq], "forward_backward_ms": ms,
                      "median_ms": statistics.median(ms), "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                      "init_s": init_s, "card": card}), flush=True)


if __name__ == "__main__":
    main()
