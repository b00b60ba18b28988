"""The port's counterparts of ``examples/``: the same programs over
``repro_torch``, run as ``python -m repro_torch.examples.<name>``. Each
runs on the card unless ``--device cpu`` is given, and raises when asked
for a card that is not there."""

from __future__ import annotations

import argparse

import torch

__all__ = ["device", "device_arg", "device_name"]


def device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")


def device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the examples run on the card unless --device cpu is given")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
