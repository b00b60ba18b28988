"""Scenario-campaign engine: plan, then execute.

Counterpart of ``repro/sim/campaign.py``, with its spec, its groups and
its result. A :class:`CampaignSpec` declares a grid of FL scenarios — a
base :class:`~repro_torch.fl.FLConfig` plus per-cell overrides and a seed
list. Execution is two explicit stages:

**Plan** (:func:`repro_torch.sim.plan.plan_campaign`) lowers the spec into a
:class:`~repro_torch.sim.plan.CampaignPlan` — one :class:`PlanGroup` per
prepared runner:

1. Cells bucket by their **static signature** (every FLConfig field that
   shapes the round). Cells differing only in :data:`VMAP_FIELDS` (lr,
   momentum, prox weight, b_init, seed, async latency/decay, and the
   attack, the bit_flip and straggler gates included) share one group.
2. Cells that are :func:`~repro_torch.sim.plan.fusable` additionally **fuse
   across differing** ``n_clients``: the client axis pads to the group max
   and each cell's real M rides ``CellParams.m_active``; the 0/1
   active-client mask folds into the Eq.-13 vote counts via the
   weighted-count path, wire format unchanged.
3. ``shard=True`` spreads each group's runs over the ranks of the client
   group (:func:`repro_torch.distributed.client_group`); with one rank it
   warns once and runs unsharded.

**Execute** (:func:`run_campaign`) walks the plan:

* each group is prepared once — its round contexts and stacked inputs on
  the device — through a process-wide :class:`~repro_torch.sim.plan.CompileCache`,
  so a repeated campaign prepares nothing;
* every group runs all its E = cells x seeds runs at once through the
  round's group form (:func:`~repro_torch.fl.rounds.fl_round`,
  :func:`~repro_torch.fl.rounds.stream_fl_round`,
  :func:`~repro_torch.fl.rounds.async_fl_round` or
  :func:`~repro_torch.fl.hierarchy.tree_fl_round` with a leading E, on
  every wire; its inputs from :mod:`repro_torch.sim.batched`), as the
  reference's ``jax.vmap(cell_fn)`` does: each kernel is launched once a
  step for the whole group;
* dispatch is **overlapped**: every group's rounds are queued on the device
  before the first group's results are read, and nothing inside a group's
  rounds waits for the device;
* a sharded group pads its E runs to a multiple of the n ranks with copies
  of the last run; rank ``k`` prepares and runs only its contiguous
  ``E_pad / n`` runs (as one group), and the runs'
  trajectories are gathered in rank order, so every rank assembles the
  same results;
* per-group accounting lands in ``CampaignResult.groups`` (and its JSON),
  with the reference's keys: wall/compile seconds (``compile_s`` is the
  preparation), cache hit, ``n_devices``, ``cells_per_sec``, padded-vs-real
  element counts, ``backend`` (``"cuda"`` or ``"cpu"``) and
  ``kernel_engine``.

A :class:`Task` says where its cells run: on the card unless its
``device`` is ``"cpu"``, and with its ``engine`` forcing the kernel engine
(``"ref"`` runs the plain versions on the card). At a fixed seed each cell
reproduces ``FLSimulation`` (same key schedule, same per-round math; see
``tests/test_torch_campaign.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from .. import distributed, prng
from ..core import is_timing_attack, is_wire_attack
from ..fl import FLConfig
from ..fl import rounds as R
from ..interop import _leaves
from ..kernels import resolve_engine
from . import batched
from .metrics import CampaignResult, CellResult
from .plan import (
    CampaignPlan,
    CompileCache,
    PlanGroup,
    default_compile_cache,
    plan_campaign,
)

__all__ = [
    "VMAP_FIELDS",
    "ACCOUNTING_FIELDS",
    "Task",
    "CellSpec",
    "CampaignSpec",
    "group_signature",
    "run_campaign",
]

# FLConfig fields that may differ between the runs of one group: the
# round's group form reads them per run (CellParams), never from the group's
# config. ``async_buffer`` is not here — it shapes the buffer, so sync and
# async cells form separate groups, but both kinds run inside one
# ``run_campaign`` call. ``n_clients`` is not here either: it is a *shape*
# — but the planner can still fuse an M-sweep by padding + masking.
VMAP_FIELDS = frozenset(
    {"lr", "momentum", "lam", "b_init", "attack", "seed",
     "async_latency", "staleness_decay"}
)

# FLConfig fields that never enter a round at all — pure host-side
# bookkeeping (the DP accountant only shapes the reported eps_spent
# trajectory). Cells differing solely here share one group.
ACCOUNTING_FIELDS = frozenset({"dp_accountant"})


@dataclasses.dataclass(frozen=True)
class Task:
    """The learning task a campaign cell runs on (data + model + metrics),
    and where: ``device`` (None: the card, which must exist) and ``engine``
    (None: by device; ``"ref"`` forces the plain versions)."""

    init_params: Any
    loss_fn: Callable
    acc_fn: Callable
    client_x: Any  # (n_clients, per_client, ...)
    client_y: Any  # (n_clients, per_client)
    test: dict
    device: Any = None
    engine: str | None = None


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One scenario cell: a name plus FLConfig field overrides."""

    name: str
    overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """A scenario grid: base config, cells, seeds.

    ``base`` holds FLConfig kwargs shared by every cell; each cell's
    overrides are applied on top. ``seeds`` drive the training RNG
    (``FLConfig.seed`` in base/overrides is ignored — the campaign owns
    the seed axis).
    """

    base: Mapping[str, Any]
    cells: tuple[CellSpec, ...]
    seeds: tuple[int, ...] = (0,)

    def config(self, cell: CellSpec) -> FLConfig:
        return FLConfig(**{**dict(self.base), **dict(cell.overrides)})

    def configs(self) -> list[FLConfig]:
        return [self.config(c) for c in self.cells]

    @staticmethod
    def from_grid(
        base: Mapping[str, Any],
        axes: Mapping[str, Sequence[Any]],
        seeds: Sequence[int] = (0,),
    ) -> "CampaignSpec":
        """Cartesian product over ``axes`` (dict field -> values).

        Cell names are ``field=value`` pairs joined with ``|`` in axis
        order, e.g. ``attack=gaussian|aggregator=rsa``.
        """
        names = list(axes)
        cells = []
        for combo in itertools.product(*(axes[n] for n in names)):
            overrides = dict(zip(names, combo))
            cells.append(
                CellSpec("|".join(f"{k}={v}" for k, v in overrides.items()), overrides)
            )
        return CampaignSpec(base=dict(base), cells=tuple(cells), seeds=tuple(seeds))


def group_signature(cfg: FLConfig) -> tuple:
    """The static signature — cells sharing it share one group."""
    return tuple(
        getattr(cfg, f.name)
        for f in dataclasses.fields(FLConfig)
        if f.name not in VMAP_FIELDS and f.name not in ACCOUNTING_FIELDS
    )


def _batched_inputs(ctx, cfgs: list[FLConfig], seeds: Sequence[int], *, masked: bool = False):
    """Stack per-(cell, seed) CellParams (numpy (E,) arrays), PRNG keys
    ((E, 2) on the context's device) and the runs' initial state with a
    leading E."""
    params, keys, b_inits = _cell_inputs(ctx, cfgs, seeds, masked=masked)
    return params, keys, batched.init_group_state(ctx, b_inits)


def _cell_inputs(ctx, cfgs: list[FLConfig], seeds: Sequence[int], *, masked: bool = False):
    """The (cell, seed) runs' CellParams, keys and initial b."""
    elems = [(cfg, s) for cfg in cfgs for s in seeds]
    params = R.CellParams(
        lr=np.asarray([c.lr for c, _ in elems], np.float32),
        momentum=np.asarray([c.momentum for c, _ in elems], np.float32),
        lam=np.asarray([c.lam for c, _ in elems], np.float32),
        attack_id=np.asarray([R.cell_params(c).attack_id for c, _ in elems], np.int32),
        flip_gate=np.asarray([is_wire_attack(c.attack) for c, _ in elems], np.bool_),
        # f64, as one run's Python float: its f32 arrival probability is made from it
        latency=np.asarray([c.async_latency for c, _ in elems], np.float64),
        staleness_decay=np.asarray([c.staleness_decay for c, _ in elems], np.float32),
        straggler_gate=np.asarray([is_timing_attack(c.attack) for c, _ in elems], np.bool_),
        # Real (unpadded) client count; only masked (fused) groups read it.
        m_active=np.asarray([c.n_active for c, _ in elems], np.int32) if masked else None,
    )
    keys = torch.stack([prng.key(s, ctx.device) for _, s in elems])
    b_inits = np.asarray([c.b_init for c, _ in elems], np.float32)
    return params, keys, b_inits


_WARNED_SINGLE_DEVICE = False


def _shard_group():
    """The process group a sharded campaign spreads its runs over, and its
    ranks: ``(None, 1)`` with no group or a world of one, which runs
    unsharded and warns once a process."""
    global _WARNED_SINGLE_DEVICE
    group = distributed.client_group()
    n = distributed.group_size(group)
    if n > 1:
        return group, n
    if not _WARNED_SINGLE_DEVICE:
        _WARNED_SINGLE_DEVICE = True
        warnings.warn(
            "run_campaign(shard=True) is a no-op: only one local device is visible. Start several ranks "
            "(torchrun --nproc-per-node N) to shard it.",
            RuntimeWarning,
            stacklevel=4,
        )
    return None, 1


def _pad_clients(arr: np.ndarray, m_pad: int) -> np.ndarray:
    """Pad the leading client axis to ``m_pad`` with wrap-around rows.

    Padded clients train on (copies of) real data so every per-row value
    stays finite; the active-client mask keeps them out of the estimate,
    the b-vote, and the metrics, and their w_local/residual rows are never
    read back per cell.
    """
    arr = np.asarray(arr)
    if arr.shape[0] == m_pad:
        return arr
    return arr[np.arange(m_pad) % arr.shape[0]]


def _task_leaves(task: Task, *, with_clients: bool) -> list:
    """The task objects a prepared runner is built from."""
    leaves = [leaf for _, leaf in _leaves(task.init_params)]
    leaves += [task.loss_fn, task.acc_fn]
    leaves += [task.test[k] for k in sorted(task.test)]
    if with_clients:
        leaves += [task.client_x, task.client_y]
    return leaves


def _task_device(task: Task) -> torch.device:
    if task.device is not None:
        return torch.device(task.device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "campaign tasks run on the card by default and no CUDA device is "
            "available; give the Task device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


class _GroupFusionError(Exception):
    """A fused group's cells turned out not to share a batchable task."""


def _peak_bytes_est(ctx, n_elems_per_dev: int) -> int:
    """Estimated peak resident bytes of one rank's aggregation path.

    Padded wire rows + the server's accumulator, per (cell, seed) element,
    times the elements a rank carries. Dense rounds hold all
    ``n_clients`` wire rows; streamed rounds hold one ``client_chunk``-row
    chunk plus the O(d) count/sum carry (fed_gm's buffer kind still holds
    every row — streaming it is a parity fallback, not a memory win).
    Reported per group in the campaign JSON so streaming-vs-dense memory
    is visible without a profiler.
    """
    cfg = ctx.cfg
    d = ctx.d
    rows = cfg.client_chunk or cfg.n_clients
    p_bytes = ctx.pipeline.compressor.wire_bytes(d)
    kind = ctx.pipeline.server.stream_kind
    if p_bytes is None:  # dense wire (FedAvg / Fed-GM)
        if cfg.client_chunk and kind == "buffer":
            rows = cfg.n_clients
        wire = rows * d * 4
        acc = d * 4
    else:
        wire = rows * p_bytes
        acc = 8 * p_bytes * 4  # one int32/f32 vote count per padded bit
        if cfg.tree_edges:
            # the stacked per-edge count tensors at the root, and the
            # bounded edge buffer when there is one
            acc += (cfg.tree_edges + cfg.edge_buffer) * 8 * p_bytes * 4
    return n_elems_per_dev * (wire + acc)


class _GroupRunner:
    """A plan group prepared for execution: its round context and its
    stacked inputs on the device. Calling it runs the group's rounds and
    returns each metric's (E, rounds) trajectory on the device, without
    waiting for it; :meth:`run` also returns the runs' final global models.

    A runner holds no per-client plane: the runs' initial states are made
    when it runs and released with its rounds, so the cache that keeps
    runners keeps only contexts, params, keys and data."""

    def __init__(self, task: Task, ctx_cfg: FLConfig, cfgs: list[FLConfig], seeds: tuple, client_x, client_y,
                 data_idx, *, wire_flip: bool, masked: bool, with_acc: bool, device: torch.device, group=None):
        self.with_acc = with_acc
        self.group = group
        self.ctx = R.make_context(
            ctx_cfg, task.init_params, task.loss_fn, task.acc_fn, client_x[0] if masked else client_x,
            client_y[0] if masked else client_y, task.test, device=device, engine=task.engine,
            wire_flip=wire_flip, masked=masked,
        )
        self.params, self.keys, self.b_inits = _cell_inputs(self.ctx, cfgs, seeds, masked=masked)
        if group is not None:
            # this rank's contiguous block of the runs, padded to a multiple
            # of the ranks with copies of the last run
            n, k = len(self.b_inits), distributed.group_rank(group)
            block = -(-n // distributed.group_size(group))
            mine = [min(i, n - 1) for i in range(k * block, (k + 1) * block)]
            fields = {f.name: getattr(self.params, f.name) for f in dataclasses.fields(R.CellParams)}
            self.params = R.CellParams(**{k: None if v is None else v[mine] for k, v in fields.items()})
            self.keys, self.b_inits = self.keys[mine], self.b_inits[mine]
            if data_idx is not None:
                data_idx = np.asarray(data_idx)[mine]
        self.data = None
        if masked:
            self.data = batched.GroupData(
                client_x=R._to(client_x, device).float(), client_y=R._to(client_y, device).long(),
                data_idx=torch.as_tensor(data_idx, dtype=torch.int64, device=device),
            )
        self.group_params = batched.device_params(self.params, device)

    def run(self) -> tuple[dict, torch.Tensor]:
        state, traj = R.run_rounds(self.ctx, self.group_params, self.keys,
                                   batched.init_group_state(self.ctx, self.b_inits),
                                   data=self.data, with_acc=self.with_acc)
        return traj, state.w_global

    def __call__(self) -> dict:
        """The whole group's trajectories: this rank's runs', and on a
        sharded group every rank's, gathered in rank order (padded runs
        included)."""
        traj = self.run()[0]
        if self.group is None:
            return traj
        return {k: distributed.all_gather_rows(v, self.group).flatten(0, 1) for k, v in traj.items()}


def _prepare_group(
    group: PlanGroup,
    cfgs: list[FLConfig],
    spec: CampaignSpec,
    task_fn: Callable[[FLConfig], Task],
    *,
    with_acc: bool,
    shard: bool,
    cache: CompileCache,
):
    """Build (preparer, its args, cache key, keepalive, element counts,
    device count, peak-bytes estimate) for one plan group; the preparer,
    called on the args, returns the group's runner.

    For a fused group the per-cell client datasets are padded to
    ``group.m_pad`` and stacked once along a *cell* axis; each (cell, seed)
    run reads its cell's rows. The representative cell supplies the init
    params / loss / test set, which a fusable task provider must keep
    M-independent; a shape mismatch raises :class:`_GroupFusionError` and
    the executor falls back to per-signature execution for that group.
    """
    group_cfgs = [cfgs[i] for i in group.cell_idx]
    wire_flip = any(is_wire_attack(c.attack) for c in group_cfgs)
    n = len(group_cfgs) * len(spec.seeds)

    if group.fused:
        tasks = [task_fn(c) for c in group_cfgs]
        task = tasks[0]
        cxs = [_pad_clients(t.client_x, group.m_pad) for t in tasks]
        cys = [_pad_clients(t.client_y, group.m_pad) for t in tasks]
        if len({c.shape for c in cxs}) > 1 or len({c.shape for c in cys}) > 1:
            raise _GroupFusionError(
                f"per-client data shapes differ across the fused M group "
                f"{[spec.cells[i].name for i in group.cell_idx]}"
            )
        ctx_cfg = dataclasses.replace(group_cfgs[0], n_clients=group.m_pad)
        client_x, client_y = np.stack(cxs), np.stack(cys)
        data_idx = np.repeat(np.arange(len(group_cfgs)), len(spec.seeds))
        keepalive = _task_leaves(task, with_clients=False)
    else:
        task = task_fn(group_cfgs[0])
        ctx_cfg = group_cfgs[0]
        client_x, client_y, data_idx = task.client_x, task.client_y, None
        keepalive = _task_leaves(task, with_clients=True)
    if group.client_chunk and ctx_cfg.client_chunk == 0:
        # Planner-chosen streaming: the padded client axis exceeded the
        # stream threshold, so the group's rounds loop over chunks.
        ctx_cfg = dataclasses.replace(ctx_cfg, client_chunk=group.client_chunk)
    device = _task_device(task)
    shard_group, n_dev = _shard_group() if shard else (None, 1)
    if shard_group is not None and (ctx_cfg.stream_shard or ctx_cfg.tree_shard):
        raise ValueError("run_campaign(shard=True) spreads runs over the ranks; its cells cannot shard their own "
                         "clients over them too (unset stream_shard/tree_shard)")

    key = (
        group.signature, group.m_pad, group.fused, group.client_chunk,
        wire_flip, with_acc, n_dev, cache.task_fingerprint(keepalive),
        tuple(group_cfgs), tuple(spec.seeds), str(device), task.engine,
    )
    prepare = functools.partial(
        _GroupRunner, task, wire_flip=wire_flip, masked=group.fused, with_acc=with_acc, device=device,
        group=shard_group,
    )
    args = (ctx_cfg, group_cfgs, tuple(spec.seeds), client_x, client_y, data_idx)
    return prepare, args, key, keepalive, n, -(-n // n_dev) * n_dev, n_dev


def _demote_group(group: PlanGroup, cfgs: list[FLConfig]) -> list[PlanGroup]:
    """Fallback for an unfusable-in-practice fused group: per-signature."""
    sub: dict[tuple, list[int]] = {}
    for i in group.cell_idx:
        sub.setdefault(group_signature(cfgs[i]), []).append(i)
    return [
        PlanGroup(
            signature=("static", *sig),
            cell_idx=tuple(idxs),
            m_pad=cfgs[idxs[0]].n_clients,
            fused=False,
        )
        for sig, idxs in sub.items()
    ]


def run_campaign(
    spec: CampaignSpec,
    task_fn: Callable[[FLConfig], Task],
    *,
    shard: bool | None = None,
    with_acc: bool = True,
    verbose: bool = False,
    fuse_m: bool | None = None,
    plan: CampaignPlan | None = None,
    compile_cache: CompileCache | None = None,
) -> CampaignResult:
    """Plan (unless handed a plan) and execute a campaign grid.

    ``task_fn(cfg)`` supplies the task for a cell's config (called once
    per group member for fused groups, once per group otherwise — memoize
    inside if building data is expensive). ``fuse_m=False`` disables
    heterogeneous-M fusion (the parity baseline); ``compile_cache``
    defaults to the process-wide preparation cache, so repeated campaigns
    of the same spec prepare nothing. When an explicit ``plan`` is handed
    in it owns the ``shard``/``fuse_m`` decisions — passing a conflicting
    flag alongside it is an error, not a silent override.

    Execution is overlapped: all groups are prepared and *dispatched*
    first, then collected in dispatch order. A group's ``wall_s``
    therefore measures dispatch-to-ready (device work overlaps the host's
    dispatch of later groups); ``compile_s`` is the preparation time, zero
    on a cache hit. Both land in ``CampaignResult.groups`` together with
    ``n_devices``, ``cells_per_sec`` (real (cell, seed) elements per
    wall-second), and the padded-vs-real element counts.
    """
    if plan is None:
        plan = plan_campaign(
            spec,
            fuse_m=True if fuse_m is None else fuse_m,
            shard=bool(shard),
        )
    else:
        for name, arg, planned in (
            ("shard", shard, plan.shard), ("fuse_m", fuse_m, plan.fuse_m)
        ):
            if arg is not None and arg != planned:
                raise ValueError(
                    f"run_campaign({name}={arg}) conflicts with the explicit "
                    f"plan ({name}={planned}); set it in plan_campaign() or "
                    "drop the keyword"
                )
    cache = compile_cache if compile_cache is not None else default_compile_cache()
    cfgs = spec.configs()

    t_start = time.perf_counter()
    launched: list[dict] = []
    worklist = list(plan.groups)
    while worklist:
        group = worklist.pop(0)
        try:
            prepare, args, key, keepalive, n, n_padded, n_dev = _prepare_group(
                group, cfgs, spec, task_fn,
                with_acc=with_acc, shard=plan.shard, cache=cache,
            )
        except _GroupFusionError as e:
            warnings.warn(
                f"demoting fused campaign group to per-M execution: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
            worklist = _demote_group(group, cfgs) + worklist
            continue
        t0 = time.perf_counter()
        hits_before = cache.hits
        runner = cache.compile(key, prepare, args, keepalive=keepalive)
        t_compile = time.perf_counter() - t0
        t_dispatch = time.perf_counter()
        out = runner()
        launched.append(
            dict(
                group=group, out=out, n=n, n_padded=n_padded, n_dev=n_dev,
                t_dispatch=t_dispatch, compile_s=t_compile,
                cache_hit=cache.hits > hits_before,
                peak_bytes=_peak_bytes_est(runner.ctx, -(-n_padded // n_dev)),
                backend=runner.ctx.device.type, engine=runner.ctx.engine,
            )
        )

    cell_results: dict[int, CellResult] = {}
    group_stats: list[dict] = []
    n_seeds = len(spec.seeds)
    for L in launched:
        group: PlanGroup = L["group"]
        traj = {m: v.cpu().numpy()[: L["n"]] for m, v in L["out"].items()}  # waits for the group
        wall = time.perf_counter() - L["t_dispatch"]
        for j, i in enumerate(group.cell_idx):
            metrics = {
                m: v[j * n_seeds : (j + 1) * n_seeds] for m, v in traj.items()
            }
            # Cumulative DP budget under the cell's accountant — closed
            # form on the host, seed-independent, so the trajectory is
            # tiled across the seed axis like any other metric.
            eps_traj = cfgs[i].ledger().trajectory(cfgs[i].rounds)
            metrics["eps_spent"] = np.tile(eps_traj[None, :], (n_seeds, 1))
            cell_results[i] = CellResult(
                name=spec.cells[i].name,
                overrides=dict(spec.cells[i].overrides),
                metrics=metrics,
            )
        stats = {
            "cells": [spec.cells[i].name for i in group.cell_idx],
            "wall_s": wall,
            "compile_s": L["compile_s"],
            "cache_hit": L["cache_hit"],
            "fused": group.fused,
            "m_pad": group.m_pad,
            "client_chunk": (
                group.client_chunk or cfgs[group.cell_idx[0]].client_chunk
            ),
            "tree_edges": cfgs[group.cell_idx[0]].tree_edges,
            "peak_bytes_est": L["peak_bytes"],
            "n_devices": L["n_dev"],
            "n_elems": L["n"],
            "n_elems_padded": L["n_padded"],
            "cells_per_sec": L["n"] / wall if wall > 0 else float("inf"),
            # Which engine served the kernels: the dispatch policy
            # (kernels.ops.resolve_engine) picks it by device unless the
            # task forces one; "torch" when the cells use no kernels.
            "backend": L["backend"],
            "kernel_engine": (
                resolve_engine(L["engine"], L["backend"])
                if cfgs[group.cell_idx[0]].use_kernels
                else "torch"
            ),
        }
        group_stats.append(stats)
        if verbose:
            kind = "fused" if group.fused else "static"
            print(
                f"[campaign] {kind} group of {group.n_cells} cells x "
                f"{n_seeds} seeds on {L['n_dev']} device(s): {wall:.2f}s "
                f"exec + {L['compile_s']:.2f}s prepare"
                f"{' (cached)' if L['cache_hit'] else ''} "
                f"({stats['cells_per_sec']:.1f} cells/s: "
                f"{', '.join(stats['cells'])})"
            )

    return CampaignResult(
        cells=[cell_results[i] for i in range(len(cfgs))],
        seeds=spec.seeds,
        groups=group_stats,
        wall_s=time.perf_counter() - t_start,
    )
