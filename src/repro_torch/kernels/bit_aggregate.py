"""Binding of the vote-count + Eq.-13 estimate kernel (B3).

``bit_aggregate`` replaces the Pallas ``bit_aggregate_2d``
(``repro/kernels/bit_aggregate.py``); the CUDA source is
``csrc/bit_aggregate.cu``. Any ``P`` bytes a row, any ``M`` clients below
2**24 and a range ``b`` of the true length ``n <= 8P``: the TPU kernel's
128-byte lane and 256-row client tiles are gone.

The launch covers (column tiles x client slabs) of each element of a
group (the grid's second dimension; one run is E = 1):
:func:`launch_geometry` picks both, and the C entry launches what it is
given. On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.bit_aggregate_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, ref

__all__ = ["WARPS", "TILE_BYTES", "MAX_CLUSTER", "STREAM_ROWS", "launch_geometry", "bit_aggregate"]

WARPS = 4  # row streams (warps) per block
TILE_BYTES = 128  # wire bytes of one column tile: one 4-byte word per lane
MAX_CLUSTER = 8  # blocks per thread-block cluster (the portable limit)
STREAM_ROWS = 96  # rows a stream takes before the cluster doubles: six 16-row groups


def launch_geometry(m: int, n: int) -> tuple[int, int]:
    """(column tiles, blocks per cluster) of the launch for ``m`` clients
    and ``n`` coordinates.

    A tile covers the ``TILE_BYTES`` wire bytes of 1024 coordinates; tiles
    wholly at or beyond ``n`` are not launched. Its cluster of blocks splits
    the clients into ``cluster * WARPS`` row streams: stream ``s = rank *
    WARPS + warp`` reads rows ``s, s + S, s + 2S, ...`` with ``S = cluster *
    WARPS``. The cluster doubles, up to ``MAX_CLUSTER``, while a stream
    would get more than ``STREAM_ROWS`` rows. Below that a block's fixed
    latency (the launch, one round of loads, the cluster barriers) costs
    more than its rows: measured on the H100 at P = 14,848, one block a
    tile is the fastest up to a few hundred clients (M = 100 included),
    4 from about a thousand and 8 from a few thousand (``PERF.md``).
    """
    tiles = -(-(-(-n // 8)) // TILE_BYTES)
    cluster = 1
    while cluster < MAX_CLUSTER and m > STREAM_ROWS * WARPS * cluster:
        cluster *= 2
    return tiles, cluster


def bit_aggregate(packed: torch.Tensor, b: torch.Tensor, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """packed (M, P) uint8, b (n,) f32 with 1 <= n <= 8P -> theta_hat (n,) f32;
    or a group of E elements, packed (E, M, P) and b (E, n) -> (E, n), each
    element counted over its own M rows (one launch, E up to 65,535).

    Wire bits of coordinates ``>= n`` are never written. ``out``, when
    given, is a contiguous f32 buffer of the result's shape on the same
    device that receives the result.
    """
    if packed.dim() not in (2, 3) or packed.dtype != torch.uint8 or not packed.is_contiguous():
        raise ValueError(f"packed: need contiguous uint8 (M, P) or (E, M, P), got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    m, p = packed.shape[-2:]
    lead = packed.shape[:-2]
    if (b.dim() != packed.dim() - 1 or b.shape[:-1] != lead or not 1 <= b.shape[-1] <= 8 * p
            or b.dtype != torch.float32 or not b.is_contiguous()):
        raise ValueError(f"b: need contiguous f32 {tuple(lead)} + (n,) with 1 <= n <= {8 * p}, "
                         f"got {b.dtype} {tuple(b.shape)}")
    n = b.shape[-1]
    elements = lead[0] if lead else 1
    if b.device != packed.device:
        raise ValueError(f"b is on {b.device}, packed on {packed.device}")
    if m < 1 or m >= 2**24:
        raise ValueError(f"client count must be in [1, 2**24), got {m}")
    if not 1 <= elements <= 65_535:
        raise ValueError(f"element count must be in [1, 65535], got {elements}")
    if out is not None and (out.shape != b.shape or out.dtype != torch.float32 or not out.is_contiguous()
                            or out.device != packed.device):
        raise ValueError(f"out: need contiguous f32 {tuple(b.shape)} on {packed.device}")
    if packed.device.type == "cpu":
        theta = ref.bit_aggregate_ref(packed, b)
        return theta if out is None else out.copy_(theta)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if out is None:
        out = torch.empty(b.shape, dtype=torch.float32, device=packed.device)
    tiles, cluster = launch_geometry(m, n)
    recip = float(np.float32(1.0) / np.float32(m))
    lib = _build.library("bit_aggregate")
    rc = lib.probit_bit_aggregate(
        packed.data_ptr(), b.data_ptr(), out.data_ptr(), m, p, n, recip, tiles, cluster, elements,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _build.check(rc, "bit_aggregate")
    return out
