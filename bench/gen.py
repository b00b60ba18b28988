"""The benchmark's inputs, made from ``--seed`` on the device.

One general generator for every configuration and traffic mix: initial
parameters, token batches, images and labels are drawn with a
``torch.Generator`` on the run's device, each kind of input from its own
sub-seed of the run's seed, in a few large calls. The same seed gives the
same inputs on the same device; the program under test and the reference
both receive them from here.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one kind of input of run ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, *tags))
    return g


def normal_leaves(leaves: list, seed: int, device, tag: str) -> dict:
    """``{name: tensor}`` for ``(name, shape, init, scale, dtype)`` leaves:
    zeros, ones, or ``scale * normal`` drawn in f32 (one draw a leaf, in
    order) and rounded once to ``dtype``."""
    g = generator(device, seed, tag)
    out = {}
    for name, shape, init, scale, dtype in leaves:
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = (torch.randn(shape, generator=g, dtype=torch.float32, device=device) * scale).to(dtype)
    return out


def lm_tokens(seed: int, r: int, shape: tuple, vocab: int, device) -> torch.Tensor:
    """Round ``r``'s token sequences, int64 of ``shape`` (clients, local
    steps, sequences a step, sequence length + 1), uniform over the
    vocabulary."""
    return torch.randint(vocab, shape, generator=generator(device, seed, "tokens", r), device=device)


def image_clients(seed: int, traffic: dict, clients: int, img: int, channels: int, classes: int, device):
    """Label-skewed synthetic images: ``classes`` smooth prototypes (a
    ``prototype_grid`` square of normals upsampled to ``img``), each client
    holding ``per_client`` images of ``classes_per_client`` classes, each
    image its prototype plus ``noise`` times a normal. Returns NHWC f32
    images (clients, per_client, img, img, channels) and int64 labels
    (clients, per_client)."""
    g = generator(device, seed, "images")
    grid, n = traffic["prototype_grid"], traffic["per_client"]
    protos = torch.randn((classes, grid, grid, channels), generator=g, device=device)
    protos = protos.repeat_interleave(img // grid, 1).repeat_interleave(img // grid, 2)
    own = torch.rand((clients, classes), generator=g, device=device).argsort(-1)[:, : traffic["classes_per_client"]]
    pick = torch.randint(traffic["classes_per_client"], (clients, n), generator=g, device=device)
    labels = own.gather(1, pick)
    noise = torch.randn((clients, n, img, img, channels), generator=g, device=device)
    return protos[labels] + traffic["noise"] * noise, labels
