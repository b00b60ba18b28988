"""Multi-pod dry run: trace a step of an (architecture x input shape) on the
production mesh of a fake process group, allocating nothing, and report
its roofline terms.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each case on 256 or 512 host placeholder devices; the port
starts a ``"fake"`` process group of 256 or 512 ranks in this one process
(:func:`~repro_torch.launch.mesh.fake_world`), builds the parameters as
DTensors of fake tensors (``FakeTensorMode``) with the reference's
placements (FSDP over "data", tensor and expert parallelism over
"model"), the inputs and caches likewise, and runs the train step,
prefill or decode on them: every operation, collective and allocation of
rank 0 is seen (:mod:`.flopcount`, :class:`.analysis.CollectiveRecorder`)
and nothing is computed or allocated. ``t_lower_s`` is the trace's time;
there is no compile.

The step traces with ``engine="ref"``: the reference's mesh step lowers
its plain pipeline too, and a kernel's launch cannot take a fake tensor.

Depth and cohort: the port's loops over layers and clients run as Python
loops, each iteration traced. A full-depth model with 8 clients a rank
would take many minutes, so by default a case is traced at 2 and 3
pattern units (and, for training, 2 and 3 clients a pod; :func:`trace_points`),
and every reported quantity, which grows linearly in each past the first
(FLOPs, bytes, collectives, the live bytes of parameters, gradients and
checkpoints; the backward writes each stacked gradient once), is
extrapolated bilinearly to the whole case; ``traces`` in the report lists
the traced points, and ``--exact`` traces the whole case instead;
``--check-fit`` does both and prints the fields where they differ
(:func:`check_fit`; ``--layers`` cuts a published config to a depth whose
exact trace is quick). A depth or cohort of at most 3 is traced whole.
The fit's one remainder is the wire rows' padding: the compressor packs
each leaf's shard to whole bytes, padded, which is not linear in depth
where a unit's shard is not a multiple of the padding. A training report
fitted in depth carries one row's remainder at the whole depth,
``fit_wire_row_remainder_bytes`` (0 where there is none); the fitted
cross-pod gather of the rows is off by it times the rows it moves. On the
reduced qwen2 (remainder 0) the fit equals an exact trace in dot FLOPs and
collectives, on the reduced qwen3-moe it does but for that gather, and on
both it is within 0.1% in peak and bytes a device
(``tests/test_torch_dryrun_depth.py``). Rank 0
of a training step on several pods traces its own pod's clients, so the
FLOPs and bytes are those times the pods, which each do the same work.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] --out reports/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --reduced --shape train_4k \\
      --device cpu --mesh 2x2x2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from .. import configs, distributed
from ..core import build_pipeline
from ..models import SHAPES, build_specs, cache_logical, init_cache, prefill, serve_step
from ..models.config import ModelConfig, ShapeConfig
from ..models.inputs import batch_structure
from ..models.spec import is_spec, param_placements
from ..tree import leaves, unflatten
from .analysis import CollectiveRecorder, LiveBytes, collective_totals, roofline_terms
from .fl_step import DistFLConfig, make_fl_train_step
from .flopcount import FlopCounter
from .mesh import fake_world, make_mesh, make_production_mesh

__all__ = ["SKIPS", "LONG_WINDOW", "cache_plan", "build_case", "trace_points", "run_case", "check_fit", "main"]

SKIPS: dict[tuple[str, str], str] = {
    ("hubert-xlarge", "decode_32k"): "encoder-only: no autoregressive decode step",
    ("hubert-xlarge", "long_500k"): "encoder-only: no autoregressive decode step",
}

# long_500k window variant for full-attention archs
LONG_WINDOW = 8192


def cache_plan(cfg: ModelConfig, shape: ShapeConfig) -> tuple[int, int]:
    """(cache_len, ring_window) for decode shapes."""
    if "attn" not in cfg.pattern:
        return 8, 0  # no attention cache; minimal placeholder length
    if cfg.sliding_window and shape.seq_len > cfg.sliding_window:
        return cfg.sliding_window, cfg.sliding_window
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        return LONG_WINDOW, LONG_WINDOW
    return shape.seq_len, 0


def _on_mesh(x: torch.Tensor, mesh, logical: tuple) -> torch.Tensor:
    return distributed.keep_shard(x, mesh, distributed.placements_for(mesh, logical, tuple(x.shape)))


def _empty_shard(shape: tuple, dtype, device, mesh, placements):
    """A DTensor of ``shape`` whose shard is an empty tensor of this rank's
    piece (no whole tensor made)."""
    local, _ = distributed.shard_bounds(shape, mesh, placements)
    return distributed.from_shard(torch.empty(local, dtype=dtype, device=device), mesh, placements, shape)


def _param_layout(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp: bool):
    """The parameter specs, the mesh they live on and each leaf's placements.
    A training step's parameters live on each pod's ("data", "model") part
    of the mesh: the pods train their own clients, and only the wire rows,
    votes and losses cross them."""
    specs = build_specs(cfg)
    n_pods = distributed.mesh_sizes(mesh).get("pod", 1)
    p_mesh = mesh["data", "model"] if shape.kind == "train" and n_pods > 1 else mesh
    pl = leaves(param_placements(specs, p_mesh, "data" if fsdp else None), is_leaf=lambda x: isinstance(x, tuple))
    return specs, p_mesh, pl


def _wire_row_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp: bool, fl_agg: str, rand_bits: int) -> int:
    """One client's wire row on rank 0 (its shard of every leaf), packed as
    the round's compressor packs each leaf: to whole bytes, padded, so not
    linear in depth where a unit's shard is not a multiple of the padding."""
    specs, p_mesh, pl = _param_layout(cfg, shape, mesh, fsdp)
    dims = [math.prod(distributed.shard_bounds(s.shape, p_mesh, p)[0]) for s, p in zip(leaves(specs, is_leaf=is_spec), pl)]
    if fl_agg != "probit_plus":
        return 4 * sum(dims)
    compressor = build_pipeline("probit_plus", rand_bits=rand_bits, use_kernels=rand_bits == 32, engine="ref").compressor
    return sum(compressor.wire_bytes(d) for d in dims)


def build_case(cfg: ModelConfig, shape: ShapeConfig, mesh, fl_clients: int = 16, fl_agg: str = "probit_plus",
               rand_bits: int = 32, fsdp: bool = True, device: str = "cuda", m_seq: int | None = None):
    """``(fn, args)`` of one case, to be called inside ``FakeTensorMode``
    with ``mesh`` current: the parameters as DTensors with the reference's
    placements, and the train step's cohort batch, the prefill batch or
    the decode cache and token. ``m_seq`` cuts the cohort to that many
    clients a pod (the dry run's extrapolation)."""
    n_pods = distributed.mesh_sizes(mesh).get("pod", 1)
    specs, p_mesh, pl = _param_layout(cfg, shape, mesh, fsdp)
    params = unflatten(specs, [_empty_shard(s.shape, s.dtype, device, p_mesh, p)
                               for s, p in zip(leaves(specs, is_leaf=is_spec), pl)], is_leaf=is_spec)
    if shape.kind == "train":
        pb = shape.global_batch // fl_clients
        if pb < 1 or fl_clients % n_pods:
            raise ValueError(f"{fl_clients} clients do not split {shape.name}'s batch over {n_pods} pods")
        m = fl_clients // n_pods if m_seq is None else m_seq
        # the whole cohort's batch on every rank; each pod rank trains its column
        batch = {k: torch.empty((m, n_pods, 1) + sh, dtype=dt, device=device)
                 for k, (sh, dt, _) in batch_structure(cfg, pb, shape.seq_len, "train").items()}
        b = torch.empty((), dtype=torch.float32, device=device)
        key = torch.zeros((2,), dtype=torch.int64, device=device)
        fl = DistFLConfig(clients_per_round=m * n_pods, aggregator=fl_agg, rand_bits=rand_bits, remat=True)
        return make_fl_train_step(cfg, fl, engine="ref"), (params, b, batch, key)
    kind = "prefill" if shape.kind == "prefill" else "decode"
    batch = {k: _on_mesh(torch.empty(sh, dtype=dt, device=device), mesh, lg)
             for k, (sh, dt, lg) in batch_structure(cfg, shape.global_batch, shape.seq_len, kind).items()}
    if kind == "prefill":
        return (lambda p, bt: prefill(p, bt, cfg)), (params, batch)
    cache_len, window = cache_plan(cfg, shape)
    cache = [{k: _on_mesh(v, mesh, log[k]) for k, v in c.items()}
             for c, log in zip(init_cache(cfg, shape.global_batch, cache_len, device), cache_logical(cfg))]
    pos = cache_len - 1 if window == 0 else shape.seq_len - 1

    def fn(p, c, bt):
        return serve_step(p, c, bt, pos, cfg, window)

    return fn, (params, cache, batch)


def _local_tensors(tree) -> list:
    return [x.to_local() if distributed.is_dtensor(x) else x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def _trace(cfg, shape, mesh, device, pod_stride: int, **kw) -> dict:
    """One trace of rank 0: its quantities (global FLOPs and bytes, its
    collectives, its memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = build_case(cfg, shape, mesh, device=device, **kw)
        rec, live = CollectiveRecorder(mesh, pod_stride=pod_stride), LiveBytes()
        live.track(_local_tensors(args))
        arg = live.live
        counter = FlopCounter(live)
        with rec, counter:
            out = fn(*args)
        q = {"flops_total": counter.flops, "bytes_total": counter.bytes, "dot_flops": counter.dot_flops,
             "arg": arg, "peak": live.peak,
             "output": sum(t.numel() * t.element_size() for t in _local_tensors(out))}
        q.update(collective_totals(rec.collectives))
    return q


def trace_points(reps: int, m_full: int, exact: bool = False) -> list[tuple[int, int]]:
    """The (units, clients a pod) points a case is traced at: the whole case
    when ``exact``, else each of depth and cohort whole up to 3 and at 2
    and 3 past it. The first unit is not a typical unit (its live bytes
    peak lower), nor is a one-client cohort (its row plane's reshapes are
    views where a larger cohort's copy), so neither is traced to fit."""
    if exact:
        return [(reps, m_full)]
    units = (reps,) if reps <= 3 else (2, 3)
    clients = (m_full,) if m_full <= 3 else (2, 3)
    return [(r, m) for r in units for m in clients]


def _bilinear(q: dict, reps: int, m: int) -> dict:
    """Each quantity at (reps, m) from its values at the traced points
    ``q[(r, c)]``, linear in each of r and c from its two traced values,
    one apart (one value: that coordinate is traced whole)."""
    rs, cs = sorted({r for r, _ in q}), sorted({c for _, c in q})

    def along(f0, f1, lo, hi, at):
        return f0 if hi == lo else f0 + (at - lo) * (f1 - f0)

    keys = set().union(*(v.keys() for v in q.values()))
    out = {}
    for k in keys:
        f = {pt: v.get(k, 0) for pt, v in q.items()}
        r0, r1, c0, c1 = rs[0], rs[-1], cs[0], cs[-1]
        at_c0 = along(f[(r0, c0)], f[(r1, c0)], r0, r1, reps)
        at_c1 = along(f[(r0, c1)], f[(r1, c1)], r0, r1, reps)
        out[k] = along(at_c0, at_c1, c0, c1, m)
    return out


def _mesh_for(multi_pod: bool, mesh_shape: tuple | None, device: str):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type=device)
    names = ("pod", "data", "model")[-len(mesh_shape):]
    return make_mesh(mesh_shape, names, device)


def run_case(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    fl_clients: int = 16,
    indexed: bool = False,
    tag: str = "",
    fl_agg: str = "probit_plus",
    rand_bits: int = 32,
    serve_2d: bool = False,
    layer_remat: bool = False,
    remat: str = "full",
    ssm_dtype: str = "float32",
    pure_dp: bool = False,
    *,
    device: str | None = None,
    mesh_shape: tuple | None = None,
    reduced: bool = False,
    exact: bool = False,
    layers: int = 0,
) -> dict:
    """The reference's report of one case (its variants and fields), traced
    on a fake world of the mesh's size. ``mesh_shape`` replaces the
    production mesh (e.g. ``(2, 2, 2)``, axes named as the production
    mesh's last ones); ``reduced`` takes the registry's reduced config;
    ``layers`` cuts the config to that many layers (0: all);
    ``shape_name`` may be a ``ShapeConfig`` of its own (a small one for
    tests)."""
    from ..models.model import inner_remat, remat_policy
    from ..models.ssm import ssm_state_dtype

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the dry run traces for the card unless --device cpu is given")
        device = "cuda"
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    dims = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    report: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, dims)),
        "variant": tag or ("indexed" if indexed else "baseline"),
        "engine": "ref",
        "device": device,
    }
    if indexed:
        # the reference's lever; the port's layer loop always indexes each unit's parameters
        report["same_as"] = "this case without indexed_params"
    if (arch, shape_name) in SKIPS:
        report["status"] = "skipped"
        report["reason"] = SKIPS[(arch, shape_name)]
        return report
    cfg = configs.get_config(arch)
    if reduced:
        cfg = configs.reduced(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        report["n_layers"] = layers
    multi = len(dims) == 3
    t0 = time.perf_counter()
    try:
        with fake_world(math.prod(dims)):
            mesh = _mesh_for(multi_pod, mesh_shape, device)
            if pure_dp:
                # no tensor parallelism: weights replicated, the batch over data (+pod)
                rules_ctx = distributed.use_rules(ff=(), heads=(), kv=(), vocab=(), seq=(), experts=())
                batch_ax = ("pod", "data") if (multi and shape.kind != "train") else ("data",)
                fsdp = False
            elif serve_2d and shape.kind == "decode":
                # 2-D weight-stationary serving: weights over both axes
                rules_ctx = distributed.use_rules(ff=("model", "data"), vocab=("model", "data"), experts=("model",))
                batch_ax = ("data",)
                fsdp = False
            else:
                rules_ctx = contextlib.nullcontext()
                batch_ax = ("pod", "data") if (multi and shape.kind != "train") else ("data",)
                fsdp = True
            n_pods = distributed.mesh_sizes(mesh).get("pod", 1)
            m_full = fl_clients // n_pods if shape.kind == "train" else 1
            reps = cfg.reps
            points = trace_points(reps, m_full, exact)
            pod_stride = math.prod(dims[1:]) if multi else math.prod(dims)
            traced = {}
            with distributed.set_mesh(mesh), rules_ctx, inner_remat(layer_remat), remat_policy(remat), \
                    ssm_state_dtype(ssm_dtype), distributed.use_batch_axes(*batch_ax):
                for r, m in points:
                    cut = cfg if r == reps else dataclasses.replace(cfg, n_layers=r * cfg.unit)
                    kw = dict(fl_clients=fl_clients, fl_agg=fl_agg, rand_bits=rand_bits, fsdp=fsdp)
                    if shape.kind == "train":
                        kw["m_seq"] = m
                    traced[(r, m)] = _trace(cut, shape, mesh, device, pod_stride, **kw)
                units = sorted({r for r, _ in points})
                if shape.kind == "train" and len(units) > 1:
                    # the fit's one remainder: each leaf's packed row rounds up
                    rows = {r: _wire_row_bytes(cfg if r == reps else dataclasses.replace(cfg, n_layers=r * cfg.unit),
                                               shape, mesh, fsdp, fl_agg, rand_bits) for r in (*units, reps)}
                    fitted = rows[units[0]] + (reps - units[0]) * (rows[units[1]] - rows[units[0]])
                    report["fit_wire_row_remainder_bytes"] = rows[reps] - fitted
            t_lower = time.perf_counter() - t0
            q = traced[points[0]] if len(points) == 1 else _bilinear(traced, reps, m_full)
            if shape.kind == "train" and n_pods > 1:
                # rank 0 traces its own pod's clients, on that pod's part of
                # the mesh; every pod does the same work on its own
                q = dict(q, **{k: q[k] * n_pods for k in ("flops_total", "bytes_total", "dot_flops")})
            n_dev = mesh.size()
            memory = {"arg": q["arg"], "output": q["output"], "peak": q["peak"],
                      "temp": max(q["peak"] - q["arg"] - q["output"], 0)}
            terms = roofline_terms(q, q, n_dev, memory)
        report.update(terms)
        report["status"] = "ok"
        report["t_lower_s"] = round(t_lower, 1)
        report["traces"] = [{"units": r, "clients_per_pod": m} for r, m in points]
        report["extrapolated"] = len(points) > 1
        report["global_flops"] = q["flops_total"]
        report["n_params"] = cfg.n_params()
        report["n_active_params"] = cfg.n_active_params()
        print(f"[{arch} x {shape_name} x {report['mesh']}] trace: peak={terms['peak_bytes_per_device'] / 2**30:.2f}GiB "
              f"args={terms['arg_bytes_per_device'] / 2**30:.2f}GiB per device")
        print(f"[{arch} x {shape_name} x {report['mesh']}] roofline: "
              f"flops/dev={terms['flops_per_device']:.3e} "
              f"bytes/dev={terms['bytes_per_device']:.3e} "
              f"coll={terms['collective_link_bytes']:.3e}B "
              f"bottleneck={terms['bottleneck']}")
    except Exception as e:  # a failure here is a bug in the sharding of the port
        report["status"] = "error"
        report["error"] = f"{type(e).__name__}: {e}"[:2000]
        report["traceback"] = traceback.format_exc()[-4000:]
    return report


def check_fit(*args, **kwargs) -> dict:
    """One case (:func:`run_case`'s arguments) fitted and traced exactly:
    both reports and each field of the exact one that the fit does not
    equal, with the fit's relative gap where the field is a number."""
    fit, whole = (run_case(*args, **kwargs, exact=exact) for exact in (False, True))
    apart = {}
    for k, v in whole.items():
        if k in ("t_lower_s", "traces", "extrapolated") or fit.get(k) == v:
            continue
        number = isinstance(v, (int, float)) and not isinstance(v, bool) and v
        apart[k] = {"fit": fit.get(k), "exact": v, "relative": (fit[k] - v) / v if number else None}
    return {"fit": fit, "exact": whole, "apart": apart}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fl-clients", type=int, default=16)
    ap.add_argument("--fl-agg", default="probit_plus", choices=["probit_plus", "fedavg_fp32"])
    ap.add_argument("--serve-2d", action="store_true", help="2D weight-stationary decode layout (perf variant)")
    ap.add_argument("--layer-remat", action="store_true", help="nested per-layer remat inside the pattern unit")
    ap.add_argument("--remat", default="full", choices=["full", "dots"], help="remat policy for the unit loop")
    ap.add_argument("--ssm-dtype", default="float32", choices=["float32", "bfloat16"], help="SSM chunk-state dtype")
    ap.add_argument("--pure-dp", action="store_true", help="no tensor parallelism: replicated weights")
    ap.add_argument("--rand-bits", type=int, default=32, choices=[16, 32])
    ap.add_argument("--indexed-params", action="store_true",
                    help="the reference's per-iteration parameter gather; the port's loop always indexes, so "
                         "the numbers are those without it (the report says so in same_as)")
    ap.add_argument("--tag", default="", help="variant tag for the report filename")
    ap.add_argument("--out", default=None, help="directory for JSON reports")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device type of the fake tensors (default cuda; raises without a card)")
    ap.add_argument("--mesh", default=None, help="a mesh shape such as 2x2x2 in place of the production mesh")
    ap.add_argument("--reduced", action="store_true", help="the registry's reduced config of --arch")
    ap.add_argument("--exact", action="store_true", help="trace the whole depth and cohort (no extrapolation)")
    ap.add_argument("--layers", type=int, default=0, help="cut the config to this many layers (0: all)")
    ap.add_argument("--check-fit", action="store_true",
                    help="trace each case fitted and exactly, and print the fields where the fit differs")
    args = ap.parse_args(argv)

    cases = [(a, s) for a in configs.ARCH_IDS for s in SHAPES] if args.all else [(args.arch, args.shape)]
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    results = []
    for arch, shape in cases:
        kw = dict(
            indexed=args.indexed_params, tag=args.tag,
            fl_agg=args.fl_agg, rand_bits=args.rand_bits, serve_2d=args.serve_2d,
            layer_remat=args.layer_remat, remat=args.remat, ssm_dtype=args.ssm_dtype,
            pure_dp=args.pure_dp, device=args.device, mesh_shape=mesh_shape, reduced=args.reduced,
            layers=args.layers,
        )
        if args.check_fit:
            fit = check_fit(arch, shape, args.multi_pod, args.fl_clients, **kw)
            rep = dict(fit["exact"], fit_traces=fit["fit"]["traces"], fit_t_lower_s=fit["fit"].get("t_lower_s"),
                       fit_wire_row_remainder_bytes=fit["fit"].get("fit_wire_row_remainder_bytes"),
                       fields_apart=fit["apart"])
        else:
            rep = run_case(arch, shape, args.multi_pod, args.fl_clients, **kw, exact=args.exact)
        results.append(rep)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            suffix = f"__{args.tag}" if args.tag else ""
            name = f"{arch}__{shape}__{'mp' if args.multi_pod else 'sp'}{suffix}.json"
            with open(os.path.join(args.out, name), "w") as f:
                json.dump(rep, f, indent=1, default=str)
        status = rep["status"]
        print(f"== {arch} x {shape}: {status} "
              f"{'(' + rep.get('reason', rep.get('error', ''))[:120] + ')' if status != 'ok' else ''}")
        print(json.dumps({k: v for k, v in rep.items() if k != "traceback"}, default=str))
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n{len(results)} cases: {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
