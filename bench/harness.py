"""One run of one cell: set-up, the measured window, the traced round, the
check against the reference, and the result line.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``bench/configs/<name>.json``)
and traffic mix (``bench/traffic/<name>.json``); the cell's limits are in
``bench/workloads/<cell>.json``; the configuration's ``kind`` names the
module that runs its program (``bench/systems/<kind>.py``); each per-layer metric
is read by ``bench/metrics/<metric>.py``. A metric split by the kind of
cell that reports it (``round_s.lm``, ``compress_ms.vision``: one bound,
or one end-to-end metric moved, for each kind) is the quantity before the
first dot: its reader is ``bench/metrics/<quantity>.py`` unless the split
name has a file of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
COMPARED_ROUNDS = 2  # rounds of set-up that the reference follows
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> CellSpec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "bench" / "workloads" / f"{name}.json").read_text())["limits"]
    return CellSpec(name=name, chips=cell["chips"], config=config, traffic=traffic, limits=limits,
                    end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                    per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def system(kind: str):
    return importlib.import_module(f"bench.systems.{kind}")


def quantity(name: str) -> str:
    """The quantity a metric's name measures: the name before its first dot."""
    return name.split(".")[0]


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{quantity(name)}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def set_precision(config: dict) -> None:
    import torch

    torch.use_deterministic_algorithms(bool(config.get("deterministic", False)))
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))


@contextlib.contextmanager
def tf32_as_configured(config: dict):
    """TF32 on or off as the configuration states, restored after: the
    reference computes in the configuration's precision whatever the
    process's flags are."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader may read."""

    round_s: float  # the window's seconds a round
    spans_ms: dict  # stage -> stream ms of an unprofiled round after the window (CUDA events)
    trace: object  # trace.RoundTrace of the round after it, profiled with the card's activity alone
    work: dict  # the cell's work a round from shapes


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def build_and_record(spec: CellSpec, seed: int, device, plant=None):
    """Set-up: the cell built from the seed and driven through its compared
    rounds by the window's own call (the first round warms up every
    shape). ``plant`` (a function of the cell returning a context) breaks
    the program under every round, for the benchmark's own tests and
    readings. Returns the cell, its record and the open plant context."""
    from .systems import common

    set_precision(spec.config)
    t = time.perf_counter()
    cell = system(spec.config["kind"]).Cell(spec.config, spec.traffic, seed, device)
    sync(device)
    cell.setup_seconds = {"inputs": time.perf_counter() - t, "rounds": []}
    stack = contextlib.ExitStack()
    if plant is not None:
        stack.enter_context(plant(cell))
    record = common.Record()
    with cell.watching():
        for _ in range(COMPARED_ROUNDS):
            t = time.perf_counter()
            cell.round()
            sync(device)
            record.rounds.append(cell.snapshot())
            cell.setup_seconds["rounds"].append(time.perf_counter() - t)
    return cell, record, stack


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool, device, t_start: float,
             plant=None) -> dict:
    """One run: set-up, the window of whole rounds from a round boundary to
    the first boundary at or after ``seconds``; when traced, a round with
    the stage spans, a round under the profiler with the card's activity
    alone (the device metrics) and one with the host's too (the idle gaps'
    labels); then the check, once the program's state is freed."""
    import torch

    from . import trace as tracing
    from .systems import common

    on_card = torch.device(device).type == "cuda"
    cell, record, stack = build_and_record(spec, seed, device, plant)
    with stack:
        setup_s = time.perf_counter() - t_start
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rounds, failed, marks = 0, 0, []
        t0 = time.perf_counter()
        while True:
            cell.round()
            sync(device)
            marks.append(time.perf_counter())
            rounds += 1
            failed += not all(math.isfinite(x) for x in cell.losses())
            window = marks[-1] - t0
            if window >= seconds:
                break
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        round_s = window / rounds
        per_layer, breakdown, dev_extra, profiled = {}, None, {}, []
        t_trace = time.perf_counter()
        if trace:
            # the stage spans on a round of their own, unprofiled; then the rounds under the profiler
            spans = tracing.Spans(cell.span_targets, device)
            with spans.active():
                cell.round()
                sync(device)
            rt = tracing.profile_round(cell.round, device, host=False)
            labelled = tracing.profile_round(cell.round, device, host=True)
            ctx = TraceContext(round_s=round_s, spans_ms=spans.ms(), trace=rt, work=cell.work())
            for m in spec.per_layer:
                value = metric_reader(m["name"])(ctx)
                if value is not None:
                    per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
            dev_extra = {"busy_s": rt.busy_s, "window_s": rt.window_s}
            top = sorted(rt.by_name.items(), key=lambda kv: -kv[1])[:10]
            breakdown = {"device_ops": [[n[:200], s] for n, s in top], "idle_gaps": labelled.idle_gaps}
            profiled = [rt.window_s, labelled.window_s]
    setup_parts = cell.setup_seconds
    cell.free()
    del cell
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = checked_numbers(spec, seed, device, record)
    phases = {"setup": setup_s, "setup_inputs": setup_parts["inputs"], "setup_rounds": setup_parts["rounds"],
              "window_rounds": [b - a for a, b in zip([t0] + marks, marks)], "profiled_rounds": profiled,
              "trace": t_check - t_trace,
              "check": time.perf_counter() - t_check}
    e2e = {"round_s": {"value": round_s, "unit": "s"}, "peak_mem_gb": {"value": peak / 1e9, "unit": "GB"},
           "setup_s": {"value": setup_s, "unit": "s"}}
    metrics = per_layer if trace else {m["name"]: e2e[quantity(m["name"])] for m in spec.end_to_end}
    device_line = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": spec.chips, "memory_peak_bytes": int(peak), **dev_extra}
    if on_card:
        device_line["power_limit_w"] = power_limit_w()
    result = {"correct": common.judge(numbers, spec.limits), "attempted": rounds, "failed": failed,
              "metrics": metrics, "device": device_line}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["phase_seconds"] = phases
    result["checks"] = {k: {"value": numbers.get(k), "limit": lim} for k, lim in spec.limits.items()}
    return result


def checked_numbers(spec: CellSpec, seed: int, device, record) -> dict:
    """The numbers of ``record`` (the program's, or a stand-in's) held to
    the reference, which follows it from the seed's inputs."""
    with tf32_as_configured(spec.config):
        return system(spec.config["kind"]).check(spec.config, spec.traffic, seed, device, record)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
