"""Whole runs of tiny stand-ins of the cells on the CPU: the result line,
a sound run that is correct, and runs that must come out not correct: the
control (the reference in the precision below the configuration's, in
the program's place) and the program broken under the window's call."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import LM_CELL, ROOT, VISION_CELL, tiny_spec

CONTRACT_KEYS = ("correct", "attempted", "failed", "metrics", "device")
SEED = 2**31 + 12345


def _run(cell, trace=False, plant=None, seconds=0.2, device="cpu"):
    from bench import harness

    return harness.run_cell(tiny_spec(cell), SEED, seconds, trace, device, time.perf_counter(), plant=plant)


@pytest.mark.parametrize("cell", [LM_CELL, VISION_CELL])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(cell, trace):
    result = _run(cell, trace)
    assert set(CONTRACT_KEYS) <= set(result) and list(result)[-1] == "checks"
    assert set(result) <= set(CONTRACT_KEYS) | {"breakdown", "phase_seconds", "checks"}
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    json.loads(json.dumps(result))
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
        assert any(name.startswith("round_mfu.") for name in result["metrics"])
    else:
        kind = tiny_spec(cell).config["kind"]
        assert set(result["metrics"]) == {f"round_s.{kind}", "peak_mem_gb", "setup_s"}
    for c in result["checks"].values():
        assert c["value"] is not None and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell, fault", [(cell, fault) for cell in (LM_CELL, VISION_CELL)
                                         for fault in ("unchanged", "half_clients", "flip_row")]
                         + [(VISION_CELL, "stale_client")])
def test_a_broken_program_is_not_correct(cell, fault):
    from bench.calibrate import plant

    result = _run(cell, plant=plant(fault))
    assert result["correct"] is False
    if fault == "stale_client":  # one client's lost update: the largest step gap, not the median
        checks = result["checks"]
        assert checks["step_gap_max"]["value"] > checks["step_gap_max"]["limit"]
        assert checks["step_gap"]["value"] <= checks["step_gap"]["limit"]


def _control_correct(cell, device, **config):
    from bench import harness
    from bench.systems import common

    spec = tiny_spec(cell, **config)
    sysmod = harness.system(spec.config["kind"])
    rec = sysmod.control_record(spec.config, spec.traffic, SEED, device, harness.COMPARED_ROUNDS)
    return common.judge(harness.checked_numbers(spec, SEED, device, rec), spec.limits)


def test_the_lm_control_in_fp8_is_not_correct():
    assert _control_correct(LM_CELL, "cpu") is False


@pytest.mark.cuda
def test_the_vision_control_in_tf32_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    # the published widths, on 4 clients
    assert _control_correct(VISION_CELL, "cuda", width=64, blocks=[2, 2, 2, 2], image_size=32, clients=4) is False


def _command(cwd):
    return subprocess.run([sys.executable, "bench/run.py", "--workload", LM_CELL, "--seed", "1", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
