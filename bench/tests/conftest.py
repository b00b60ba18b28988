"""Shared set-up of the benchmark's own tests: the checkout's root and the
program's sources on the path, torch on two threads, and tiny stand-ins of
the cells that run on the CPU in seconds."""

from __future__ import annotations

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

LM_CELL, VISION_CELL = "qwen2-1.5b-m4.probit", "resnet18w64-m100.probit"
# Tiny widths of each cell's configuration and traffic (the CPU's sizes).
TINY = {
    LM_CELL: ({"num_hidden_layers": 2, "hidden_size": 512, "intermediate_size": 768, "num_attention_heads": 4,
               "num_key_value_heads": 2, "vocab_size": 512, "clients": 3}, {"seq": 16}),
    VISION_CELL: ({"width": 8, "blocks": [1, 1, 1, 1], "image_size": 16, "clients": 6}, {"per_client": 20}),
}


@pytest.fixture(scope="session", autouse=True)
def _few_threads():
    import torch

    torch.set_num_threads(2)


@pytest.fixture(scope="session")
def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_spec(cell: str, **config):
    """The cell as ``harness.load_cell`` gives it, cut to :data:`TINY`
    (with ``config``'s keys instead where given)."""
    from bench import harness

    spec = harness.load_cell(cell, ROOT)
    cfg, traffic = TINY[cell]
    spec.config = {**spec.config, **cfg, **config}
    spec.traffic = {**spec.traffic, **traffic}
    return spec
