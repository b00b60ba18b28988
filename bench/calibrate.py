"""Readings that the cells' limits are set from, on the card at each
cell's own size; the benchmark's runs never run this.

  python3 bench/calibrate.py --workload <cell> --sound 11,12 --control 21,22,23 \\
      --faults half_clients,flip_row --fault-seeds 31,32,33 --out calib.jsonl

For each ``--sound`` seed the program is set up and driven through the
compared rounds (no window) and held to the reference (a ``sound``
line); for each ``--control`` seed the reference computed in the
precision below the configuration's (``CONTROL`` of the cell's system)
runs in the program's place and is held to it (a ``control`` line); for
each fault and each ``--fault-seeds`` seed the program runs with that
fault planted under every round (a line named after the fault). Each line
carries the numbers compared and the seconds each part took.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bench.run import prepare_environment  # noqa: E402

FAULTS = ("half_clients", "flip_row", "unchanged", "stale_client")


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def plant(name: str):
    """The fault ``name``: a method of the cell where its kind has one of
    its own, else one of ``systems.common``."""
    from bench.systems import common

    return lambda cell: getattr(cell, name)() if hasattr(cell, name) else getattr(common, name)()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    prepare_environment(ROOT)
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    _build.build_all()
    spec = harness.load_cell(args.workload, ROOT)
    sysmod = harness.system(spec.config["kind"])
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(line: dict) -> None:
        line = {"workload": args.workload, **line}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    def program(seed, fault=None):
        t = time.perf_counter()
        cell, record, stack = harness.build_and_record(spec, seed, dev, plant(fault) if fault else None)
        stack.close()
        cell.free()
        del cell
        torch.cuda.empty_cache()
        return record, time.perf_counter() - t

    def checked(seed, rec):
        t = time.perf_counter()
        return harness.checked_numbers(spec, seed, dev, rec), time.perf_counter() - t

    for seed in seeds(args.sound):
        rec, prog_s = program(seed)
        numbers, check_s = checked(seed, rec)
        emit({"kind": "sound", "seed": seed, "numbers": numbers, "program_s": prog_s, "check_s": check_s})
    for seed in seeds(args.control):
        t = time.perf_counter()
        rec = sysmod.control_record(spec.config, spec.traffic, seed, dev, harness.COMPARED_ROUNDS)
        control_s = time.perf_counter() - t
        numbers, check_s = checked(seed, rec)
        emit({"kind": "control", "precision": sysmod.CONTROL, "seed": seed, "numbers": numbers,
              "control_s": control_s, "check_s": check_s})
    for fault in [f for f in args.faults.split(",") if f]:
        if fault not in FAULTS:
            raise SystemExit(f"unknown fault {fault!r}; there are {FAULTS}")
        for seed in seeds(args.fault_seeds):
            rec, prog_s = program(seed, fault)
            numbers, check_s = checked(seed, rec)
            emit({"kind": fault, "seed": seed, "numbers": numbers, "program_s": prog_s, "check_s": check_s})
    if out:
        out.close()
    print(json.dumps({"calibrate_s": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
