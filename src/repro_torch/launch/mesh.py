"""Mesh construction on a ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``. The reference is one controller
over ``jax.devices()``; the port is SPMD, one process a rank, so a mesh
needs the default process group, which the caller starts (``torchrun``,
or ``init_process_group`` with a ``FileStore``, as the tests do) with as
many ranks as the mesh has. These are functions, never module-level
constants: importing this module touches no device and no group.

:func:`fake_world` starts a ``"fake"`` process group of any size in this
one process (no collective moves data): with fake tensors it lets the dry
run (:mod:`.dryrun`) trace a step on the production mesh of 256 or 512
ranks.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch

__all__ = ["fake_world", "make_mesh", "make_production_mesh", "make_host_mesh", "make_campaign_mesh"]

# The reference's production layouts: 16 x 16 = 256 chips a pod; two pods
# along a leading "pod" axis.
_PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _world() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs the default process group: start the ranks with torchrun (or call "
            "torch.distributed.init_process_group) before making one"
        )
    return dist.get_world_size()


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a ``"fake"`` process group of ``n`` ranks
    on a ``FakeStore`` (the default group inside the ``with`` block,
    destroyed on exit). Its collectives move no data: with fake tensors a
    step on a mesh of ``n`` ranks traces in one process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already started in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """``init_device_mesh(device_type, shape, mesh_dim_names=axes)`` over the
    default group, whose world must be ``prod(shape)``. The mesh is on the
    card unless ``device_type="cpu"`` asks for the CPU: without a card it
    raises, as every entry of the port does. On the card each rank takes
    ``cuda:{LOCAL_RANK % device_count}``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    world, n = _world(), math.prod(shape)
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group has {world}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh is on the card unless device_type='cpu' is given")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod; ``multi_pod`` doubles them along a leading
    "pod" axis. The default group must have exactly that many ranks, real
    or fake (:func:`fake_world`); otherwise it raises, naming the size."""
    import torch.distributed as dist

    shape, axes = _PRODUCTION[multi_pod]
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"the production mesh {shape} needs a world of {n} ranks; the process group has "
                         f"{world or 'not been started'}")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """The degenerate ``(1, model)`` mesh named ("data", "model"), the
    production mesh's names, over a world of ``model`` ranks."""
    return make_mesh((1, model), ("data", "model"), device_type)


def make_campaign_mesh(n: int | None = None, device_type: str = "cuda"):
    """A 1-D ("data",) mesh over ``n`` ranks (None: the whole world), on
    which the client axis and campaign runs spread."""
    return make_mesh((_world() if n is None else n,), ("data",), device_type)
