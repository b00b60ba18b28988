"""Roofline terms of a traced step: collectives and the H100's rates.

Counterpart of ``repro/launch/analysis.py``. The reference parses the
collectives out of the compiled HLO; the port records them as they are
issued: :class:`CollectiveRecorder` is a ``TorchDispatchMode`` that sees
every ``_c10d_functional`` collective (DTensor's redistributions and
``local_map`` regions issue these) and every ``c10d`` collective (the
client axis's own gathers), with its result bytes, its group's size,
the mesh dimension its group is, and whether the group spans pods. Link
bytes per collective use the reference's ring formulas
(:attr:`Collective.link_bytes`):

  all-reduce       2 * bytes * (n-1)/n
  all-gather       bytes_out * (n-1)/n
  reduce-scatter   bytes_out * (n-1)      (the result is the shard)
  all-to-all       bytes * (n-1)/n
  collective-permute  bytes (point to point)

:class:`LiveBytes` keeps the live bytes of this rank's local tensors (each
storage counted from its first output until it is freed) and their peak:
on fake tensors this is the per-device memory the step would take.

Hardware model: NVIDIA H100 SXM5 (80 GB HBM3) at its 700 W limit. 989.4
TFLOP/s dense bf16 and 3.35 TB/s HBM3 from NVIDIA's datasheet; the
2,990.1 GB/s copy rate measured on such a card (``chip_smoke.py`` phase 5,
PERF.md section 6) beside it; NVLink 4 at 450 GB/s each way as the link
rate.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = [
    "PEAK_FLOPS", "HBM_BW", "MEASURED_COPY_BW", "LINK_BW", "HARDWARE",
    "Collective", "CollectiveRecorder", "LiveBytes", "collective_totals", "roofline_terms",
]

# NVIDIA H100 SXM5 80 GB, 700 W limit
PEAK_FLOPS = 989.4e12  # dense bf16 tensor-core FLOP/s (datasheet)
HBM_BW = 3.35e12  # HBM3 bytes/s (datasheet)
MEASURED_COPY_BW = 2990.1e9  # device-to-device copy bytes/s (PERF.md section 6)
LINK_BW = 450e9  # NVLink 4 bytes/s each way
HARDWARE = "NVIDIA H100 SXM5 80GB HBM3, 700 W"


@dataclasses.dataclass
class Collective:
    kind: str
    result_bytes: float
    group_size: int
    spans_pods: bool = False
    dim: str = ""

    @property
    def link_bytes(self) -> float:
        n = max(self.group_size, 2)
        frac = (n - 1) / n
        if self.kind == "all-reduce":
            return 2.0 * self.result_bytes * frac
        if self.kind == "all-gather":
            return self.result_bytes * frac
        if self.kind == "reduce-scatter":
            # result is the scattered shard; input was n x larger
            return self.result_bytes * (n - 1)
        if self.kind == "all-to-all":
            return self.result_bytes * frac
        return self.result_bytes  # collective-permute


_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_C10D = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
}


def _bytes(x) -> float:
    flat, _ = tree_flatten(x)
    return float(sum(t.numel() * t.element_size() for t in flat if isinstance(t, torch.Tensor)))


class LiveBytes:
    """The live bytes of this rank's local tensors and their peak: each
    storage counted once, from the first time :meth:`track` sees a tensor
    on it until the storage is freed. A DTensor counts its local shard.
    On fake tensors this is the memory a device would hold."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def track(self, tensors) -> None:
        """Count each of a list of tensors (their storages) as live."""
        from torch.distributed.tensor import DTensor

        for t in tensors:
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)


class CollectiveRecorder(TorchDispatchMode):
    """Records the collectives this rank issues.

    ``mesh`` (optional) names each group by the mesh dimension it is;
    ``pod_stride`` is the number of ranks a pod (a group spans pods when
    its ranks fall in more than one block of that many). Operations on
    DTensors are let through (``NotImplemented``) so that DTensor issues
    its local operations and collectives, which the recorder then sees."""

    def __init__(self, mesh=None, pod_stride: int = 256):
        super().__init__()
        self.collectives: list[Collective] = []
        self._pod_stride = pod_stride
        self._names = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._names[mesh.get_group(i).group_name] = name

    def _group(self, name: str):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        pg = _resolve_process_group(name)
        ranks = dist.get_process_group_ranks(pg)
        spans = max(ranks) // self._pod_stride != min(ranks) // self._pod_stride
        return len(ranks), spans, self._names.get(name, "other")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator) or func.namespace not in ("_c10d_functional", "c10d"):
            return func(*args, **kwargs)
        ns, name = func.namespace, func._overloadpacket.__name__
        out = func(*args, **kwargs)
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            group = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
            size, spans, dim = self._group(group)
            self.collectives.append(Collective(_FUNCTIONAL[name], _bytes(out), size, spans, dim))
        elif ns == "c10d" and name in _C10D:
            import torch.distributed as dist

            pg = dist.ProcessGroup.unbox(next(a for a in args if isinstance(a, torch.ScriptObject)))
            size, spans, dim = self._group(pg.group_name)
            self.collectives.append(Collective(_C10D[name], _bytes(args[0]), size, spans, dim))
        return out


def collective_totals(collectives: list) -> dict:
    """This rank's collectives summed: ``link_bytes``, ``cross_pod``
    (link bytes of groups that span pods), ``calls``, and link bytes by
    kind (``kind:<kind>``), by mesh dimension (``dim:<dim>``) and calls by
    mesh dimension (``calls:<dim>``)."""
    out = {"link_bytes": 0.0, "cross_pod": 0.0, "calls": 0}
    for c in collectives:
        lb = c.link_bytes
        out["link_bytes"] += lb
        out["cross_pod"] += lb if c.spans_pods else 0.0
        out["calls"] += 1
        for key, val in ((f"kind:{c.kind}", lb), (f"dim:{c.dim}", lb), (f"calls:{c.dim}", 1)):
            out[key] = out.get(key, 0) + val
    return out


def roofline_terms(counts: dict, totals: dict, n_devices: int, memory: dict | None = None) -> dict:
    """Per-device roofline terms (seconds) and the raw quantities, in the
    reference's keys.

    ``counts`` is :func:`~repro_torch.launch.flopcount.count_fn`'s global
    totals; ``totals`` this rank's :func:`collective_totals`. The port has
    no compiled HLO: the ``hlo_*`` keys hold the trace's own per-device
    numbers and ``loop_correction_rho`` is 1 (the trace counts every loop
    as it runs). ``bytes_per_device`` is the trace's logical bytes over
    the devices, before any fusion (it overstates the HBM traffic, as the
    reference's raw jaxpr bytes would). ``memory``: the per-device
    ``arg``, ``temp``, ``output`` and ``peak`` bytes.
    """
    flops = counts["flops_total"] / n_devices
    bytes_accessed = counts["bytes_total"] / n_devices
    coll_bytes = totals["link_bytes"]

    def group(prefix):
        return {k[len(prefix):]: v for k, v in totals.items() if k.startswith(prefix)}

    terms = {
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_accessed,
        "loop_correction_rho": 1.0,
        "collective_link_bytes": coll_bytes,
        "cross_pod_link_bytes": totals["cross_pod"],
        "n_collectives": totals["calls"],
        "collectives_by_kind": group("kind:"),
        "collectives_by_dim": group("dim:"),
        "collective_calls_by_dim": group("calls:"),
        "dot_flops_per_device": counts.get("dot_flops", 0.0) / n_devices,
        "t_compute_s": flops / PEAK_FLOPS,
        "t_memory_s": bytes_accessed / HBM_BW,
        "t_memory_measured_s": bytes_accessed / MEASURED_COPY_BW,
        "t_collective_s": coll_bytes / LINK_BW,
        "hardware": HARDWARE,
    }
    dom = max(
        ("compute", terms["t_compute_s"]),
        ("memory", terms["t_memory_s"]),
        ("collective", terms["t_collective_s"]),
        key=lambda kv: kv[1],
    )
    terms["bottleneck"] = dom[0]
    if memory is not None:
        for k in ("arg", "temp", "output", "peak"):
            terms[f"{k}_bytes_per_device"] = int(memory[k])
    return terms
