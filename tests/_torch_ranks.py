"""Gloo ranks on the CPU for the port's mesh tests.

:func:`run_ranks` spawns ``world`` processes that join one gloo process
group through a ``FileStore`` under the test's temporary directory (no
port is opened, so several test workers can spawn at once), each on one
torch thread; every rank runs the same job and saves what it returns to a
file, which the parent reads back. The jobs import the port only (no
JAX): the parent passes them the task's numpy arrays, and holds what they
return to its own runs.
"""

from __future__ import annotations

import functools
import os
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, world: int, store: str, out: str, job: str, kwargs: dict, backend: str) -> None:
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        # the card tests' settings: every rank shares cuda:0
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if backend != "gloo":
        import repro_torch.distributed  # noqa: F401  (registers the staged backend)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        result = globals()[job](**kwargs)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, tmp_path: pathlib.Path, job: str, timeout: float = 300.0, backend: str = "gloo",
              **kwargs) -> list:
    """Run ``job(**kwargs)`` on ``world`` ranks of a ``backend`` group (gloo;
    the port's host-staged ``"staged"`` for DTensor's own collectives on the
    card); their results in rank order. A rank that fails or outlives
    ``timeout`` seconds fails the call (every rank is then stopped)."""
    out = tmp_path / f"{job}-out"
    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, str(tmp_path / f"{job}-store"), str(out), job, kwargs, backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job} on {world} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _fl_task(p0, cx, cy, test):
    from repro_torch.models import vision as tv

    return (p0, functools.partial(tv.xent_loss, tv.mlp_logits), functools.partial(tv.accuracy, tv.mlp_logits),
            cx, cy, test)


def fl_run(cfg: dict, task: tuple, rounds: int, device: str = "cpu") -> dict:
    """One FLSimulation on ``device``: each round's metrics (theta included),
    the final global model (on the CPU), the ranks the round spread over
    and the kernels' launches."""
    from repro_torch.fl import FLConfig, FLSimulation
    from repro_torch.fl.hierarchy import tree_shard_devices
    from repro_torch.kernels import _build

    p0, loss_fn, acc_fn, cx, cy, test = _fl_task(*task)
    _build.reset_launches()
    sim = FLSimulation(FLConfig(**cfg), p0, loss_fn, acc_fn, cx, cy, test, device=device)
    mets = [{k: v.cpu() for k, v in m.items()} for _, m in sim.iter_rounds(rounds)]
    group = sim.ctx.group
    return {"metrics": mets, "w_global": sim.w_global.cpu(), "tree_ranks": tree_shard_devices(sim.ctx),
            "ranks": 1 if group is None else dist.get_world_size(group), "launches": dict(_build.launches),
            "client_rows": sim.ctx.client_x.shape[0], "data_offset": sim.ctx.data_offset}


def fl_runs(cfgs: dict, task: tuple, rounds: int, device: str = "cpu") -> dict:
    """:func:`fl_run` of each named config, in order, on every rank."""
    return {name: fl_run(cfg, task, rounds, device) for name, cfg in cfgs.items()}


def campaign(base: dict, cells: list, seeds: tuple, task: tuple, mesh: tuple) -> dict:
    """``run_campaign(shard=True)`` under a CPU mesh of ``mesh = (shape,
    names)``, whose "data" dimension the runs spread over: each cell's
    metrics and the group records."""
    from repro_torch.distributed import set_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sim import CampaignSpec, CellSpec, CompileCache, Task, run_campaign

    p0, loss_fn, acc_fn, cx, cy, test = _fl_task(*task)
    spec = CampaignSpec(base=base, cells=tuple(CellSpec(n, o) for n, o in cells), seeds=seeds)
    t = Task(p0, loss_fn, acc_fn, cx, cy, test, device="cpu")
    with set_mesh(make_mesh(*mesh, device_type="cpu")):
        res = run_campaign(spec, lambda cfg: t, shard=True, compile_cache=CompileCache())
    return {"cells": {c.name: {k: np.asarray(v) for k, v in c.metrics.items()} for c in res.cells},
            "groups": res.groups}


def lm_pod_step(cfg, params: dict, batch: dict, b: float, key: torch.Tensor, fl: dict, device: str = "cpu") -> dict:
    """The LM round's step on a ("pod",) mesh of every rank on ``device``,
    on the whole (m_seq, n_pods, ...) batch: the new parameters (on the
    CPU), b, the metrics, the collectives and the kernels' launches."""
    from repro_torch import distributed, tree
    from repro_torch.kernels import _build
    from repro_torch.launch import fl_step
    from repro_torch.launch.mesh import make_mesh

    step = fl_step.make_fl_train_step(cfg, fl_step.DistFLConfig(**fl))
    mesh = make_mesh((dist.get_world_size(),), ("pod",), device)
    params, batch = (tree.tree_map(lambda x: x.to(device), t) for t in (params, batch))
    distributed.reset_collectives()
    _build.reset_launches()
    with distributed.set_mesh(mesh):
        new, b_new, metrics = step(params, torch.tensor(b, device=device), batch, key.to(device))
    return {"params": [w.cpu() for w in tree.leaves(new)], "b": float(b_new),
            "metrics": {k: float(v) for k, v in metrics.items()}, "collectives": dict(distributed.collectives),
            "launches": dict(_build.launches)}


def several(**jobs) -> dict:
    """Each named ``(job, kwargs)`` in turn on every rank: their results by
    name."""
    return {name: globals()[job](**kwargs) for name, (job, kwargs) in jobs.items()}


def stacked_grads(cfg, specs, batch: dict, mesh_shape: tuple) -> dict:
    """The gradient of ``batch``'s loss with respect to each stacked leaf,
    ``specs`` initialized as DTensors on a ("data", "model") mesh of
    ``mesh_shape`` on the CPU (FSDP over "data"): each leaf's placements
    beside its gradient's, and each gradient whole."""
    from repro_torch import distributed, prng, tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import train_loss
    from repro_torch.models.spec import init_params

    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), "cpu")
    params = init_params(specs, prng.key(0), mesh=mesh, fsdp_axis="data")
    stacked = [w.detach().requires_grad_(True) for w in tree.leaves(params["blocks"])]
    grad_tree = dict(params, blocks=tree.unflatten(params["blocks"], stacked))
    with distributed.set_mesh(mesh), distributed.mesh_context(grad_tree):
        grads = torch.autograd.grad(train_loss(grad_tree, batch, cfg), stacked)
    return {"placements": [(str(w.placements), str(g.placements)) for w, g in zip(stacked, grads)],
            "grads": [g.full_tensor() for g in grads]}


def model_axis(cfg, specs, batch: dict, step_batch: dict, b: float, key: torch.Tensor, fl: dict,
               wire_leaf: int, wire_delta: torch.Tensor, engine: str | None = None,
               mesh_shape: tuple | None = None, moe_cfg=None, moe_tokens: torch.Tensor | None = None,
               device_type: str = "cpu") -> dict:
    """The model axis on a ("data", "model") mesh of every rank on
    ``device_type``, of ``mesh_shape`` (by default (1, world)): ``specs`` initialized as
    DTensors (FSDP over "data"); the prefill logits of ``batch``; for an
    MoE config the first MoE block's expert-parallel f32 sum before its
    rounding on the embedded ``moe_tokens`` (by default the prefill
    tokens), under ``moe_cfg`` (by default ``cfg``); one LM round of ``step_batch`` (new parameters, b, metrics,
    launches); the placements of each stacked leaf and of its gradient at
    the new parameters; and the shard of leaf ``wire_leaf`` that this rank packs
    from the whole ``wire_delta``, unpacked to its bits, with the shard's
    offset. Everything comes back whole, on the CPU."""
    from repro_torch import distributed, prng, tree
    from repro_torch.core.quantizer import unpack_bits
    from repro_torch.kernels import _build
    from repro_torch.launch import fl_step
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import layers, moe, prefill, train_loss
    from repro_torch.models.spec import init_params

    if mesh_shape is None:
        mesh = make_host_mesh(dist.get_world_size(), device_type)
    else:
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device_type)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" else "cpu"
    params = init_params(specs, prng.key(0, dev), mesh=mesh, fsdp_axis="data")
    batch, step_batch = (tree.tree_map(lambda x: x.to(dev), t) for t in (batch, step_batch))
    out = {"placements": [str(w.placements) for w in tree.leaves(params)]}
    with distributed.set_mesh(mesh), torch.no_grad():
        out["logits"] = prefill(params, batch, cfg).full_tensor().cpu()
        if cfg.n_experts:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                x = layers.embed_tokens(params["embed"], batch["tokens"] if moe_tokens is None else moe_tokens)
                p = {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}
                x2d = x.reshape(-1, x.shape[-1])
                moe_out = moe._moe_on_mesh(p, x2d, moe_cfg or cfg)
                out["moe_sum"], out["moe_placements"] = moe_out.full_tensor().cpu(), str(moe_out.placements)
    step = fl_step.make_fl_train_step(cfg, fl_step.DistFLConfig(**fl), engine=engine)
    distributed.reset_collectives()
    _build.reset_launches()
    with distributed.set_mesh(mesh):
        new, b_new, metrics = step(params, torch.tensor(b, device=dev), step_batch, key.to(dev))
    out.update(params_new=[w.full_tensor().cpu() for w in tree.leaves(new)], b=float(b_new),
               metrics={k: float(v) for k, v in metrics.items()}, launches=dict(_build.launches))
    # the stacked leaves' own gradients (before any redistribution) of the
    # first client's loss at the new parameters, against their placements
    stacked = [w.detach().requires_grad_(True) for w in tree.leaves(new["blocks"])]
    grad_tree = dict(new, blocks=tree.unflatten(new["blocks"], stacked))
    first = {k: v.flatten(0, 2)[0] for k, v in step_batch.items()}  # (m, pods, steps, ...) -> one batch
    with distributed.set_mesh(mesh), distributed.mesh_context(grad_tree):
        grads = torch.autograd.grad(train_loss(grad_tree, first, cfg), stacked)
    out["stacked_placements"] = [(str(w.placements), str(g.placements)) for w, g in zip(stacked, grads)]
    leaf = tree.leaves(params)[wire_leaf]
    local, off = distributed.shard_bounds(tuple(leaf.shape), mesh, leaf.placements)
    piece = wire_delta.to(dev)[tuple(slice(o, o + n) for o, n in zip(off, local))].float()
    with torch.no_grad():
        row = fl_step._compress_shard(step.pipeline, "ref", prng.key(7, dev), piece.reshape(1, -1), leaf,
                                      torch.tensor(b, device=dev), 3)
    out["wire_bits"] = (unpack_bits(row.cpu(), piece.numel()) > 0).view(local)
    out["wire_offset"] = off
    return out
