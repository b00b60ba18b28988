"""Run one cell of the benchmark once and print its result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Without enough CUDA
cards, without the program, or with JAX loaded, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare_environment(root: pathlib.Path) -> None:
    """Fixed build directories inside the checkout, deterministic cuBLAS,
    no JAX behind any library, and the program's sources on the path."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    os.environ["USE_FLAX"] = "0"
    for path in (root / "src", root):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    args = parse_args(argv)
    prepare_environment(ROOT)
    from bench import harness

    spec = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails without the program)
    from repro_torch.kernels import _build

    t_build = time.perf_counter()
    _build.build_all()
    print(f"imports {t_build - T_START:.3f} s, kernel build {time.perf_counter() - t_build:.3f} s", file=sys.stderr)
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"refused: the process holds {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
