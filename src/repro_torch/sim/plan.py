"""Campaign planner: lower a :class:`CampaignSpec` into a ``CampaignPlan`` IR.

Counterpart of ``repro/sim/plan.py``, with the same decisions and the
same groups. The planner decides *how* a scenario grid executes before
anything runs; the executor (:func:`repro_torch.sim.campaign.run_campaign`)
walks the plan. Three decisions are encoded per group:

1. **Bucketing.** Cells sharing a static signature share one group: one
   prepared runner and one batched pass over all their (cell, seed) runs
   (:mod:`repro_torch.sim.batched`). Cells that additionally satisfy
   :func:`fusable` are bucketed by :func:`fused_signature` — the static
   signature *minus* ``n_clients`` — so a whole M-sweep lands in one bucket.
2. **Fusion.** A bucket spanning several ``n_clients`` values becomes a
   *fused* group: the client axis is padded to the group max
   (``PlanGroup.m_pad``) and each cell's real client count rides
   ``CellParams.m_active``; the 0/1 active-client mask folds into the
   Eq.-13 vote counts through the weighted-count path, so the wire format
   is unchanged. A bucket with a single M executes the unmasked round.
3. **Placement.** ``shard=True`` records the placement decision: the
   executor spreads each group's runs over the ranks of the client group
   (:func:`repro_torch.distributed.client_group`), and one rank runs the
   group unsharded.

Fusion requirements (checked per cell by :func:`fusable`): synchronous
rounds at full participation with no Byzantine cohort, dense wires, and a
non-oracle ``b``. Everything else (lr/momentum/lam/b_init/attack-id axes,
seeds, DP, error feedback, kernels) fuses freely.

Preparation is cached in a :class:`CompileCache`: where the reference
caches an AOT-compiled executable, the port caches a group's *prepared
runner* — its round contexts and its stacked inputs already on the device
— keyed by the plan group's signature, the execution flags, the task's
identity, the cells' configs and seeds, and the input shapes, so
re-running a spec prepares nothing (``lowerings`` counts preparations,
``hits`` reuses). CUDA-graph capture of a group's round waits for a later
slice (ROADMAP F3).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..fl import FLConfig

__all__ = [
    "fusable",
    "fused_signature",
    "PlanGroup",
    "CampaignPlan",
    "plan_campaign",
    "CompileCache",
    "default_compile_cache",
    "STREAM_M_THRESHOLD",
    "STREAM_CHUNK",
]

# Above this padded client count, a fusable group's rounds execute
# streamed (a loop over client chunks) instead of dense: the full
# (M, d_pad/8) wire would dominate memory while the chunked loop keeps it
# at O(STREAM_CHUNK * d/8). Below it, dense batched rounds are faster and
# memory is irrelevant. Fusable cells are always
# safe to stream: byz_frac == 0 (no colluding-attack restriction),
# participation == 1, synchronous, non-oracle b.
STREAM_M_THRESHOLD = 4096

# The client-chunk size the planner picks when it streams a group.
STREAM_CHUNK = 1024


def fusable(cfg: FLConfig) -> bool:
    """Can this cell join a fused heterogeneous-M group?

    True iff nothing about the cell's program depends on M other than
    array *sizes*: synchronous rounds (the async buffer keys slots to
    client identity), full participation (the cohort draw's shape is the
    cohort), no Byzantine rows (``n_byz = int(M * byz_frac)`` is a static
    slice bound), dense wires (SparseWire has no weighted count path), and
    non-oracle ``b`` (the oracle maxes over the padded client axis).
    """
    return (
        cfg.async_buffer == 0
        and cfg.participation >= 1.0
        and cfg.byz_frac == 0.0
        and cfg.topk_frac >= 1.0
        and cfg.b_mode != "oracle"
        # Tree rounds slice the cohort into static per-edge spans, so the
        # client axis cannot pad to a group max (an edge would straddle
        # real and padded rows with a traced boundary).
        and cfg.tree_edges == 0
    )


def fused_signature(cfg: FLConfig) -> tuple:
    """The static trace signature with the client axis removed.

    Cells sharing it — and individually :func:`fusable` — share one
    *fused* program at the padded client count; ``n_clients`` itself rides
    the traced ``CellParams.m_active``.
    """
    from .campaign import ACCOUNTING_FIELDS, VMAP_FIELDS

    skip = VMAP_FIELDS | ACCOUNTING_FIELDS | {"n_clients"}
    return tuple(
        getattr(cfg, f.name)
        for f in dataclasses.fields(FLConfig)
        if f.name not in skip
    )


@dataclasses.dataclass(frozen=True)
class PlanGroup:
    """One executable unit of a campaign: one prepared runner.

    ``cell_idx`` indexes into the spec's cells; ``m_pad`` is the padded
    client-axis size (the max ``n_clients`` over members — equal to every
    member's when ``fused`` is False). ``fused`` marks heterogeneous-M
    groups that thread the active-client mask.
    """

    signature: tuple
    cell_idx: tuple[int, ...]
    m_pad: int
    fused: bool
    # Planner-chosen streaming chunk: > 0 makes the executor run the
    # group's rounds under the chunked client loop (stream_fl_round) with
    # this chunk size. 0 = dense rounds, or the members already request a
    # chunk through FLConfig.client_chunk (which joins the signature and
    # is never overridden here).
    client_chunk: int = 0

    @property
    def n_cells(self) -> int:
        return len(self.cell_idx)


@dataclasses.dataclass(frozen=True)
class CampaignPlan:
    """Lowered form of a :class:`CampaignSpec`: what is prepared and where.

    ``shard`` records the placement decision (batch axis on a 1-D device
    mesh); the executor resolves the actual device count at run time and
    reports it per group.
    """

    spec: Any  # CampaignSpec (kept untyped to avoid a circular import)
    groups: tuple[PlanGroup, ...]
    fuse_m: bool
    shard: bool

    @property
    def n_programs(self) -> int:
        return len(self.groups)

    @property
    def n_fused(self) -> int:
        return sum(1 for g in self.groups if g.fused)

    def describe(self) -> str:
        """Human-readable plan summary (one line per group)."""
        from ..kernels import resolve_engine

        backend = default_backend()
        lines = [
            f"CampaignPlan: {len(self.spec.cells)} cells x "
            f"{len(self.spec.seeds)} seeds -> {self.n_programs} programs "
            f"({self.n_fused} fused, shard={self.shard}, "
            f"backend={backend}, "
            f"kernel_engine={resolve_engine(None, backend)})"
        ]
        for g in self.groups:
            kind = f"fused@M<={g.m_pad}" if g.fused else f"M={g.m_pad}"
            if g.client_chunk:
                kind += f", stream@{g.client_chunk}"
            g_cfg = self.spec.config(self.spec.cells[g.cell_idx[0]])
            if g_cfg.tree_edges:
                kind += f", tree@{g_cfg.tree_edges}"
                if g_cfg.edge_buffer:
                    kind += f"/buf{g_cfg.edge_buffer}"
            names = ", ".join(self.spec.cells[i].name for i in g.cell_idx)
            lines.append(f"  [{kind}] {g.n_cells} cells: {names}")
        return "\n".join(lines)


def plan_campaign(
    spec,
    *,
    fuse_m: bool = True,
    shard: bool = False,
    stream_threshold: int = STREAM_M_THRESHOLD,
    stream_chunk: int = STREAM_CHUNK,
) -> CampaignPlan:
    """Lower a spec into a :class:`CampaignPlan`.

    Grouping preserves the old engine's buckets exactly for non-fusable
    cells (static signature); fusable cells bucket by
    :func:`fused_signature` instead, merging an M-sweep into one program.
    ``fuse_m=False`` reproduces the pre-planner per-signature grouping for
    every cell (the parity baseline the fused path is tested against).

    Streaming is the plan's third decision: a fusable-keyed bucket whose
    padded client count exceeds ``stream_threshold`` gets
    ``client_chunk = stream_chunk`` — its rounds execute as the chunked
    client scan with O(stream_chunk * d/8) wire memory instead of
    materializing the (m_pad, d_pad/8) matrix. Cells that set
    ``FLConfig.client_chunk`` themselves keep their explicit chunk (it is
    part of the trace signature and never overridden).
    """
    from .campaign import group_signature

    cfgs = spec.configs()
    buckets: dict[tuple, list[int]] = {}
    for i, cfg in enumerate(cfgs):
        if fuse_m and fusable(cfg):
            key = ("fused", *fused_signature(cfg))
        else:
            key = ("static", *group_signature(cfg))
        buckets.setdefault(key, []).append(i)

    groups = []
    for key, idxs in buckets.items():
        m_values = {cfgs[i].n_clients for i in idxs}
        m_pad = max(m_values)
        stream = (
            key[0] == "fused"
            and stream_chunk > 0
            and m_pad > stream_threshold
            and cfgs[idxs[0]].client_chunk == 0
        )
        groups.append(
            PlanGroup(
                signature=key,
                cell_idx=tuple(idxs),
                m_pad=m_pad,
                # A single-M bucket runs the exact unmasked program even
                # when it bucketed by fused signature — masking would only
                # add traced-M overhead for nothing.
                fused=len(m_values) > 1,
                client_chunk=min(stream_chunk, m_pad) if stream else 0,
            )
        )
    return CampaignPlan(
        spec=spec, groups=tuple(groups), fuse_m=fuse_m, shard=shard
    )


def default_backend() -> str:
    """The device a campaign runs on unless its tasks say otherwise: the
    card, whether or not there is one (without one, such a campaign
    refuses to run; a task asks for the CPU with ``device="cpu"``)."""
    return "cuda"


class CompileCache:
    """Preparation cache: ``(plan signature, input shapes) -> prepared runner``.

    ``compile(key, fn, args)`` prepares the group on a miss — ``fn(*args)``
    builds the group's round contexts and moves its stacked inputs to the
    device, and returns the runner — and returns the cached runner on a
    hit. The key must carry everything that shapes the runner *besides*
    the argument shapes (which are derived from ``args``): the plan group's
    static signature, execution flags, a fingerprint of the task objects,
    and the cells' configs and seeds (a runner holds its inputs, so they
    are part of what it is).

    Task objects are fingerprinted by object identity
    (:meth:`task_fingerprint`); each cache entry keeps a strong reference
    to the objects behind its fingerprint (``keepalive``), so an id can
    never be recycled into a stale hit while the entry lives. Repeatedly
    running the same spec with a memoized task provider therefore prepares
    nothing after the first run; a genuinely new task object
    conservatively prepares again.

    The cache is LRU-bounded (``maxsize`` entries, default 128): a
    non-memoized task provider that rebuilds its arrays every call misses
    the id fingerprint each time, and without eviction a long-lived
    process would pin every old runner *and* its device memory forever.
    Evicting an entry drops its keepalive references with it.
    """

    def __init__(self, maxsize: int = 128):
        self._entries: dict = {}  # insertion-ordered: LRU via re-insert
        self.maxsize = maxsize
        self.lowerings = 0
        self.hits = 0

    @classmethod
    def _avals(cls, args) -> tuple:
        """(shape, dtype) of every array in ``args`` (nested sequences and
        dicts walked in order)."""
        out = []

        def walk(x):
            if isinstance(x, (np.ndarray, torch.Tensor)):
                out.append((tuple(x.shape), str(x.dtype)))
            elif isinstance(x, dict):
                for k in sorted(x):
                    walk(x[k])
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)

        walk(args)
        return tuple(out)

    @classmethod
    def _fingerprint_one(cls, obj: Any) -> tuple:
        """Structural identity of one task object.

        ``functools.partial`` wrappers are unwrapped into the identities of
        their target and bound arguments — task providers typically build a
        fresh ``partial(loss, model)`` per call around stable underlying
        functions and cached arrays, and the fresh wrapper must not defeat
        the cache. Everything else fingerprints by ``id`` (module-level
        functions and memoized arrays are stable; a genuinely new object
        conservatively prepares again).
        """
        if isinstance(obj, functools.partial):
            return (
                "partial",
                cls._fingerprint_one(obj.func),
                tuple(cls._fingerprint_one(a) for a in obj.args),
                tuple(
                    (k, cls._fingerprint_one(v))
                    for k, v in sorted(obj.keywords.items())
                ),
            )
        return ("id", id(obj))

    def task_fingerprint(self, task_objs: Sequence[Any]) -> tuple:
        """Identity fingerprint of task objects.

        The caller must pass the same objects to :meth:`compile` as
        ``keepalive`` so their ids stay valid for the entry's lifetime.
        """
        return tuple(self._fingerprint_one(o) for o in task_objs)

    def compile(
        self, key: tuple, fn: Callable, args: tuple, keepalive: Sequence[Any] = ()
    ):
        full_key = (key, self._avals(args))
        entry = self._entries.pop(full_key, None)
        if entry is None:
            self.lowerings += 1
            entry = (fn(*args), tuple(keepalive))
            while len(self._entries) >= self.maxsize:
                self._entries.pop(next(iter(self._entries)))
        else:
            self.hits += 1
        self._entries[full_key] = entry  # re-insert: most recently used last
        return entry[0]

    @property
    def size(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.lowerings = 0
        self.hits = 0


_DEFAULT_CACHE = CompileCache()


def default_compile_cache() -> CompileCache:
    """The process-wide cache ``run_campaign`` uses unless handed one."""
    return _DEFAULT_CACHE
