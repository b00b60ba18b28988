"""Mesh construction on a ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``. The reference is one controller
over ``jax.devices()``; the port is SPMD, one process a rank, so a mesh
needs the default process group, which the caller starts (``torchrun``,
or ``init_process_group`` with a ``FileStore``, as the tests do) with as
many ranks as the mesh has. These are functions, never module-level
constants: importing this module touches no device and no group.
"""

from __future__ import annotations

import math
import os

import torch

__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh", "make_campaign_mesh"]

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


def make_mesh(shape, axes, device_type: str | None = None):
    """``init_device_mesh(device_type, shape, mesh_dim_names=axes)`` over the
    default group, whose world must be ``prod(shape)``. ``device_type``
    defaults to ``"cuda"`` when the card is there, else ``"cpu"``; on the
    card each rank takes ``cuda:{LOCAL_RANK % device_count}``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    world, n = _world(), math.prod(shape)
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group has {world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks a pod; ``multi_pod`` doubles them along a leading
    "pod" axis. On fewer ranks it raises: a dry run of these meshes on a
    fake process group is ROADMAP A14b."""
    import torch.distributed as dist

    shape, axes = _PRODUCTION[multi_pod]
    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < n:
        raise NotImplementedError(
            f"the production mesh needs {n} ranks; its dry run on a fake process group is ROADMAP A14b"
        )
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1):
    """The degenerate ``(1, model)`` mesh named ("data", "model"), the
    production mesh's names, over a world of ``model`` ranks."""
    return make_mesh((1, model), ("data", "model"))


def make_campaign_mesh(n: int | None = None):
    """A 1-D ("data",) mesh over ``n`` ranks (None: the whole world), on
    which the client axis and campaign runs spread."""
    return make_mesh((_world() if n is None else n,), ("data",))
