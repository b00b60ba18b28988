"""The port's campaign planner and executor (repro_torch.sim.plan), as
``tests/test_plan.py`` holds the reference's: fused heterogeneous-M
groups equal per-group execution (rtol 1e-5, atol 1e-6, that file's bar)
for all five aggregators; the preparation cache prepares nothing on a
second identical run, is LRU-bounded and keys ``with_acc``; an explicit
plan owns its flags; a shape mismatch demotes a fused group with a
warning; ``shard=True`` on one rank warns once and runs unsharded, and on
several ranks pads, splits and gathers each group's runs (here with the
collectives faked in one process; ``tests/test_torch_shard.py`` runs real
gloo ranks).
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.data import make_classification, partition_label_skew  # noqa: E402
from repro_torch.fl import FLConfig  # noqa: E402
from repro_torch.models import accuracy, init_mlp, mlp_logits, xent_loss  # noqa: E402
from repro_torch.sim import CampaignSpec, CellSpec, CompileCache, Task, fusable, plan_campaign, run_campaign  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

AGGREGATORS = ("probit_plus", "fedavg", "fed_gm", "signsgd_mv", "rsa")
BASE = dict(rounds=3, local_epochs=1, batch_size=10)


@pytest.fixture(scope="module")
def task_factory():
    """A task provider keyed on n_clients (the benchmark-harness shape):
    shared initial model / loss / test set, per-M client partitions."""
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=150)
    p0 = init_mlp(prng.key(0), hidden=8)
    test = {"x": xte, "y": yte}
    loss_fn = functools.partial(xent_loss, mlp_logits)
    acc_fn = functools.partial(accuracy, mlp_logits)

    @functools.lru_cache(maxsize=None)
    def data(m, per_client=50):
        parts = partition_label_skew(ytr, m, 2, per_client, seed=1)
        return np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts])

    def task_fn(cfg):
        cx, cy = data(cfg.n_clients)
        return Task(p0, loss_fn, acc_fn, cx, cy, test, device="cpu")

    task_fn.data = data
    return task_fn


def m_sweep_spec(aggregator: str, seeds=(0, 1)) -> CampaignSpec:
    return CampaignSpec(
        base=dict(aggregator=aggregator, **BASE),
        cells=(
            CellSpec("M4", {"n_clients": 4}),
            CellSpec("M6", {"n_clients": 6}),
            CellSpec("M6lr", {"n_clients": 6, "lr": 0.02}),
        ),
        seeds=seeds,
    )


def test_plan_fuses_m_sweep():
    plan = plan_campaign(m_sweep_spec("probit_plus"))
    assert plan.n_programs == 1 and plan.n_fused == 1
    (g,) = plan.groups
    assert g.fused and g.m_pad == 6 and g.n_cells == 3
    assert "fused" in plan.describe()


def test_plan_fuse_m_false_reproduces_per_signature_grouping():
    plan = plan_campaign(m_sweep_spec("probit_plus"), fuse_m=False)
    assert plan.n_programs == 2 and plan.n_fused == 0  # M4 | M6+M6lr


def test_single_m_bucket_stays_unmasked():
    spec = CampaignSpec(base=dict(**BASE), cells=(CellSpec("a", {"lr": 0.01}), CellSpec("b", {"lr": 0.02})))
    plan = plan_campaign(spec)
    assert plan.n_programs == 1 and plan.n_fused == 0


def test_large_fused_bucket_streams():
    """Past STREAM_M_THRESHOLD padded clients a fused bucket streams in
    STREAM_CHUNK chunks, as the reference plans it."""
    from repro_torch.sim.plan import STREAM_CHUNK, STREAM_M_THRESHOLD

    spec = CampaignSpec(base=dict(**BASE), cells=(CellSpec("a", {"n_clients": 8}),
                                                  CellSpec("b", {"n_clients": STREAM_M_THRESHOLD + 1})))
    (g,) = plan_campaign(spec).groups
    assert g.fused and g.client_chunk == STREAM_CHUNK
    assert "stream@" in plan_campaign(spec).describe()


@pytest.mark.parametrize(
    "overrides",
    [
        dict(async_buffer=10, n_clients=10),
        dict(participation=0.5, n_clients=10),
        dict(byz_frac=0.2, n_clients=10, attack="gaussian"),
        dict(b_mode="oracle"),
    ],
)
def test_not_fusable(overrides):
    assert not fusable(FLConfig(**overrides))
    assert fusable(FLConfig())


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_fused_matches_grouped(aggregator, task_factory):
    """Fused heterogeneous-M execution equals per-group execution
    (rtol 1e-5, atol 1e-6) per cell, seed and round."""
    spec = m_sweep_spec(aggregator)
    fused = run_campaign(spec, task_factory, compile_cache=CompileCache())
    grouped = run_campaign(spec, task_factory, fuse_m=False, compile_cache=CompileCache())
    assert any(g["fused"] for g in fused.groups)
    assert not any(g["fused"] for g in grouped.groups)
    for cell in spec.cells:
        f, g = fused.cell(cell.name), grouped.cell(cell.name)
        for metric in ("acc", "loss", "b", "theta_mse"):
            np.testing.assert_allclose(f.metrics[metric], g.metrics[metric], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{aggregator}/{cell.name}/{metric}")


@pytest.mark.parametrize("aggregator", ["probit_plus", "fedavg"])
def test_streamed_fused_group_matches_grouped(aggregator, task_factory):
    """A fused group the planner streams (here past a threshold of 4
    clients, in chunks of 4) runs each run's masked stream_fl_round one run
    at a time and equals per-group execution (rtol 1e-5, atol 1e-6)."""
    spec = m_sweep_spec(aggregator)
    plan = plan_campaign(spec, stream_threshold=4, stream_chunk=4)
    (group,) = plan.groups
    assert group.fused and group.client_chunk == 4
    streamed = run_campaign(spec, task_factory, plan=plan, compile_cache=CompileCache())
    grouped = run_campaign(spec, task_factory, fuse_m=False, compile_cache=CompileCache())
    assert streamed.groups[0]["client_chunk"] == 4
    for cell in spec.cells:
        for metric in ("acc", "loss", "b", "theta_mse"):
            np.testing.assert_allclose(streamed.cell(cell.name).metrics[metric], grouped.cell(cell.name).metrics[metric],
                                       rtol=1e-5, atol=1e-6, err_msg=f"{aggregator}/{cell.name}/{metric}")


def test_fused_group_stats_report_padding(task_factory):
    spec = m_sweep_spec("probit_plus")
    res = run_campaign(spec, task_factory, compile_cache=CompileCache())
    (g,) = res.groups
    assert g["fused"] and g["m_pad"] == 6
    assert g["n_elems"] == 3 * 2 and g["n_elems_padded"] == g["n_elems"]
    assert g["n_devices"] == 1 and g["cells_per_sec"] > 0 and g["peak_bytes_est"] > 0
    js = res.to_json()
    assert js["groups"][0]["m_pad"] == 6
    assert js["n_devices"] == 1 and js["cells_per_sec"] > 0


def test_fused_shape_mismatch_demotes_to_per_m(task_factory):
    """Cells whose per-client datasets cannot stack fall back to grouped
    execution (with a warning), not a crash — and match fuse_m=False."""
    def uneven_task(cfg):
        cx, cy = task_factory.data(cfg.n_clients, 30 if cfg.n_clients == 4 else 50)
        t = task_factory(cfg)
        return Task(t.init_params, t.loss_fn, t.acc_fn, cx, cy, t.test, device="cpu")

    spec = m_sweep_spec("probit_plus", seeds=(0,))
    with pytest.warns(RuntimeWarning, match="demoting fused campaign group"):
        res = run_campaign(spec, uneven_task, compile_cache=CompileCache())
    assert not any(g["fused"] for g in res.groups)
    ref = run_campaign(spec, uneven_task, fuse_m=False, compile_cache=CompileCache())
    for cell in spec.cells:
        np.testing.assert_allclose(res.cell(cell.name).metrics["acc"], ref.cell(cell.name).metrics["acc"], atol=1e-6)


def test_second_run_triggers_zero_new_lowerings(task_factory):
    """A repeated campaign prepares nothing: every group is a cache hit
    and the results are the same."""
    spec = CampaignSpec(
        base=dict(**BASE),
        cells=(
            CellSpec("M4", {"n_clients": 4}),
            CellSpec("M6", {"n_clients": 6}),
            # not fusable (oracle b) — exercises the non-fused cache path
            CellSpec("oracle", {"n_clients": 4, "b_mode": "oracle"}),
        ),
        seeds=(0,),
    )
    cache = CompileCache()
    first = run_campaign(spec, task_factory, compile_cache=cache)
    lowerings_after_first = cache.lowerings
    assert lowerings_after_first == len(first.groups) == 2
    second = run_campaign(spec, task_factory, compile_cache=cache)
    assert cache.lowerings == lowerings_after_first, "second run prepared again"
    assert cache.hits == len(second.groups)
    assert all(g["cache_hit"] for g in second.groups)
    assert not any(g["cache_hit"] for g in first.groups)
    for cell in spec.cells:
        for metric in ("acc", "loss", "b"):
            np.testing.assert_array_equal(first.cell(cell.name).metrics[metric],
                                          second.cell(cell.name).metrics[metric])


def test_cache_key_holds_the_runs(task_factory):
    """A runner holds its runs' inputs, so other seeds or another lr in
    the same group prepare anew instead of reusing stale inputs."""
    cache = CompileCache()
    run_campaign(m_sweep_spec("probit_plus", seeds=(0,)), task_factory, compile_cache=cache)
    run_campaign(m_sweep_spec("probit_plus", seeds=(1,)), task_factory, compile_cache=cache)
    other_lr = CampaignSpec(base=dict(aggregator="probit_plus", lr=0.03, **BASE),
                            cells=m_sweep_spec("probit_plus").cells, seeds=(0,))
    run_campaign(other_lr, task_factory, compile_cache=cache)
    assert cache.lowerings == 3 and cache.hits == 0


def test_explicit_plan_rejects_conflicting_flags(task_factory):
    spec = m_sweep_spec("probit_plus", seeds=(0,))
    plan = plan_campaign(spec)  # shard=False, fuse_m=True
    with pytest.raises(ValueError, match="conflicts with the explicit plan"):
        run_campaign(spec, task_factory, shard=True, plan=plan)
    with pytest.raises(ValueError, match="conflicts with the explicit plan"):
        run_campaign(spec, task_factory, fuse_m=False, plan=plan)
    run_campaign(spec, task_factory, fuse_m=True, plan=plan, compile_cache=CompileCache())


def test_compile_cache_lru_bound(task_factory):
    """The cache evicts least-recently-used runners (and their keepalive
    references) beyond maxsize instead of growing without bound."""
    spec = m_sweep_spec("probit_plus", seeds=(0,))
    cache = CompileCache(maxsize=1)
    run_campaign(spec, task_factory, compile_cache=cache)
    assert cache.size == 1
    run_campaign(spec, task_factory, with_acc=False, compile_cache=cache)  # another runner -> evicts
    assert cache.size == 1
    run_campaign(spec, task_factory, compile_cache=cache)
    assert cache.lowerings == 3 and cache.hits == 0
    cache.clear()
    assert cache.size == 0 and cache.lowerings == 0


def test_cache_distinguishes_with_acc(task_factory):
    spec = m_sweep_spec("probit_plus", seeds=(0,))
    cache = CompileCache()
    res_acc = run_campaign(spec, task_factory, compile_cache=cache)
    res_no = run_campaign(spec, task_factory, with_acc=False, compile_cache=cache)
    assert cache.lowerings == 2 and cache.hits == 0
    assert "acc" in res_acc.cell("M4").metrics
    assert "acc" not in res_no.cell("M4").metrics


def test_shard_single_device_warns_once(task_factory, monkeypatch):
    import warnings

    from repro_torch.sim import campaign as campaign_mod

    monkeypatch.setattr(campaign_mod, "_WARNED_SINGLE_DEVICE", False)
    spec = m_sweep_spec("probit_plus", seeds=(0,))
    with pytest.warns(RuntimeWarning, match="shard=True.*no-op"):
        res = run_campaign(spec, task_factory, shard=True, compile_cache=CompileCache())
    assert all(g["n_devices"] == 1 for g in res.groups)
    assert all(g["n_elems_padded"] == g["n_elems"] for g in res.groups)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        run_campaign(spec, task_factory, shard=True, compile_cache=CompileCache())


def test_shard_over_several_cards_is_not_ported(task_factory, monkeypatch):
    """shard=True on a group of two ranks, as rank 0 sees it, with the
    collectives faked in one process (the other rank's runs are this
    rank's again): every group reports n_devices 2, pads its runs to a
    multiple of 2 with copies of the last run and reckons its memory for
    the half it runs; this rank's runs equal the unsharded campaign's."""
    from repro_torch import distributed
    from repro_torch.sim import campaign as campaign_mod

    spec = m_sweep_spec("probit_plus", seeds=(0, 1, 2))
    plain = run_campaign(spec, task_factory, compile_cache=CompileCache())
    monkeypatch.setattr(distributed, "client_group", lambda dim="data": "two ranks")
    monkeypatch.setattr(distributed, "group_size", lambda group: 1 if group is None else 2)
    monkeypatch.setattr(distributed, "group_rank", lambda group: 0)
    monkeypatch.setattr(distributed, "all_gather_rows", lambda x, group: torch.stack([x, x]))
    res = run_campaign(spec, task_factory, shard=True, compile_cache=CompileCache())
    assert [g["n_devices"] for g in res.groups] == [2] * len(res.groups)
    for g, p in zip(res.groups, plain.groups):
        assert g["n_elems"] == p["n_elems"] and g["n_elems_padded"] == -(-p["n_elems"] // 2) * 2
        assert g["peak_bytes_est"] * p["n_elems"] == p["peak_bytes_est"] * (g["n_elems_padded"] // 2)
    n_seeds = len(spec.seeds)
    block = -(-len(spec.cells) * n_seeds // 2)  # the runs rank 0 runs, in (cell, seed) order
    for j, (cell, want) in enumerate(zip(res.cells, plain.cells)):
        for s in range(n_seeds):
            if j * n_seeds + s < block:
                for metric in ("loss", "b", "acc"):
                    np.testing.assert_array_equal(cell.metrics[metric][s], want.metrics[metric][s])


def _tensors(obj, depth=0):
    """The tensors an object holds in its attributes, dataclass fields,
    dicts, lists and tuples (a few levels down)."""
    if torch.is_tensor(obj):
        yield obj
    elif depth < 4:
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
        elif isinstance(obj, dict):
            items = list(obj.values())
        elif isinstance(obj, (list, tuple)):
            items = list(obj)
        elif hasattr(obj, "__dict__") and not isinstance(obj, (types.FunctionType, functools.partial, type)):
            items = list(vars(obj).values())
        else:
            items = []
        for item in items:
            yield from _tensors(item, depth + 1)


def test_cached_runners_hold_no_client_planes(task_factory):
    """What the preparation cache keeps after a campaign holds no
    per-client model or residual plane (a tensor of d columns and at least
    M rows): the runs' states are made when a group runs and released with
    it, so a process-wide cache does not keep (E, M, d) planes alive."""
    cache = CompileCache()
    spec = m_sweep_spec("probit_plus")
    run_campaign(spec, task_factory, compile_cache=cache)
    run_campaign(spec, task_factory, compile_cache=cache)
    assert cache.size == cache.lowerings == 1
    (runner,) = [entry for entry in cache._entries.values()]
    runner = runner[0] if isinstance(runner, tuple) else runner
    d = runner.ctx.d
    planes = [t.shape for t in _tensors(runner) if t.dim() >= 2 and t.shape[-1] == d and t.numel() >= 4 * d]
    assert not planes, planes
