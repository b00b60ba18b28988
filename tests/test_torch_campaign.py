"""The port's campaign engine (repro_torch.sim) against the JAX package's
(repro.sim) and against the port's own sequential driver.

Against JAX, in one process: the grid of ``tests/test_campaign.py`` (four
cells, two seeds, the MLP at hidden 8) and a fused M-sweep (PRoBit+ and
FedAvg at M in {3, 5, 6}) run through both ``run_campaign``s, each JAX
side once in a module fixture. The groups must hold the same cells; per
cell, seed and round ``b`` is exact, ``loss`` and ``theta_mse`` agree
within the tolerance the port's MLP round tests hold against JAX (rtol
1e-4: XLA contracts the prox step and ``w + theta`` into fused
multiply-adds on the CPU, the port rounds every operation, ROADMAP C), and
``acc`` within one test sample.

Against the port's FLSimulation (the reference's own bar,
``tests/test_campaign.py``): loss within rtol 1e-6, acc within 1e-6, b
exact. The two repairs of the per-run knobs: cells that differ only in
their asynchronous latency, or only in bit_flip against gaussian, share a
group and still give their own sequential runs' results.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402,F401
from repro import sim as jsim  # noqa: E402
from repro.data import make_classification, partition_label_skew  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulation  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

BASE = dict(n_clients=6, rounds=3, local_epochs=1, byz_frac=0.34, b_mode="fixed")
SEEDS = (0, 1)
CELLS = (
    ("gaussian", {"attack": "gaussian"}),
    ("alie", {"attack": "alie"}),
    ("bit_flip", {"attack": "bit_flip"}),
    ("fedavg_gauss", {"attack": "gaussian", "aggregator": "fedavg"}),
)
SWEEP_BASE = dict(rounds=3, local_epochs=1, batch_size=10)
SWEEP = tuple((f"{agg}/M{m}", {"aggregator": agg, "n_clients": m}) for agg in ("probit_plus", "fedavg")
              for m in (3, 5, 6))
N_TEST = 150
TOL = dict(rtol=1e-4)  # the port's MLP round tests' bar against JAX (tests/test_torch_round.py)


@functools.lru_cache(maxsize=None)
def _data(m: int):
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=N_TEST)
    parts = partition_label_skew(ytr, m, 2, 50, seed=1)
    return np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts]), {"x": xte, "y": yte}


@functools.lru_cache(maxsize=None)
def _p0():
    return jax.tree_util.tree_map(np.asarray, jv.init_mlp(jax.random.PRNGKey(0), hidden=8))


@functools.lru_cache(maxsize=None)
def _jtask(m: int):
    cx, cy, test = _data(m)
    return jsim.Task(_p0(), functools.partial(jv.xent_loss, jv.mlp_logits),
                     functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)


@functools.lru_cache(maxsize=None)
def _ttask(m: int, engine=None):
    cx, cy, test = _data(m)
    return tsim.Task(_p0(), functools.partial(tv.xent_loss, tv.mlp_logits),
                     functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu", engine=engine)


def _spec(mod, base, cells):
    return mod.CampaignSpec(base=base, cells=tuple(mod.CellSpec(n, o) for n, o in cells), seeds=SEEDS)


GRIDS = {"byzantine": (BASE, CELLS), "m_sweep": (SWEEP_BASE, SWEEP)}


@pytest.fixture(scope="module")
def jax_results():
    """Each grid through the reference's run_campaign, once."""
    return {name: jsim.run_campaign(_spec(jsim, base, cells), lambda cfg: _jtask(cfg.n_clients),
                                    compile_cache=jsim.CompileCache())
            for name, (base, cells) in GRIDS.items()}


@pytest.fixture(scope="module")
def port_results():
    return {name: tsim.run_campaign(_spec(tsim, base, cells), lambda cfg: _ttask(cfg.n_clients),
                                    compile_cache=tsim.CompileCache())
            for name, (base, cells) in GRIDS.items()}


def _groups(result):
    return sorted(sorted(g["cells"]) for g in result.groups)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_groups_match_reference(grid, jax_results, port_results):
    """The same cells in each group: the attack axis rides one group
    (bit_flip included), FedAvg its own; each aggregator's M-sweep is one
    fused group in both packages."""
    assert _groups(port_results[grid]) == _groups(jax_results[grid])
    assert [g["fused"] for g in port_results[grid].groups] == [g["fused"] for g in jax_results[grid].groups]
    assert [g["m_pad"] for g in port_results[grid].groups] == [g["m_pad"] for g in jax_results[grid].groups]


@pytest.mark.parametrize("grid,cell", [(g, name) for g, (_, cells) in GRIDS.items() for name, _ in cells])
def test_trajectories_match_reference(grid, cell, jax_results, port_results):
    """Per seed and round: b exact, loss and theta_mse within the round
    tests' tolerance, accuracy within one of the 150 test samples."""
    j, t = jax_results[grid].cell(cell), port_results[grid].cell(cell)
    assert t.metrics["b"].shape == (len(SEEDS), 3)
    np.testing.assert_array_equal(t.metrics["b"], np.asarray(j.metrics["b"]))
    np.testing.assert_allclose(t.metrics["loss"], j.metrics["loss"], **TOL)
    np.testing.assert_allclose(t.metrics["theta_mse"], j.metrics["theta_mse"], atol=1e-12, **TOL)
    assert np.abs(t.metrics["acc"] - j.metrics["acc"]).max() <= 1.0 / N_TEST + 1e-7
    np.testing.assert_array_equal(t.metrics["eps_spent"], j.metrics["eps_spent"])


def _sequential(cfg_kw: dict, seed: int, task):
    sim = FLSimulation(FLConfig(seed=seed, **cfg_kw), task.init_params, task.loss_fn, task.acc_fn,
                       task.client_x, task.client_y, task.test, device="cpu")
    sim.run(eval_every=1)
    return {k: np.asarray([h[k] for h in sim.history]) for k in ("acc", "loss", "b")}


def _assert_matches_sequential(result, name: str, cfg_kw: dict, task):
    for si, seed in enumerate(SEEDS):
        seq = _sequential(cfg_kw, seed, task)
        cam = result.cell(name).metrics
        np.testing.assert_allclose(cam["acc"][si], seq["acc"], atol=1e-6, err_msg=name)
        np.testing.assert_allclose(cam["loss"][si], seq["loss"], rtol=1e-6, err_msg=name)
        np.testing.assert_array_equal(cam["b"][si], seq["b"].astype(np.float32), err_msg=name)


@pytest.mark.parametrize("grid,cell", [(g, name) for g, (_, cells) in GRIDS.items() for name, _ in cells])
def test_campaign_matches_sequential_driver(grid, cell, port_results):
    """Every cell and seed equals its own FLSimulation run (loss rtol 1e-6,
    acc 1e-6, b exact): the batched group's runs, the fused M-sweep's
    masked ones included."""
    base, cells = GRIDS[grid]
    kw = {**base, **dict(cells)[cell]}
    _assert_matches_sequential(port_results[grid], cell, kw, _ttask(kw["n_clients"]))


def test_theta_mse_metric_recorded(port_results):
    """theta_mse is finite for every cell and exactly zero for FedAvg's
    exact mean, as in the reference."""
    result = port_results["byzantine"]
    for cell in result.cells:
        assert np.all(np.isfinite(cell.metrics["theta_mse"])), cell.name
    assert np.all(result.cell("fedavg_gauss").metrics["theta_mse"] == 0.0)
    assert np.all(result.cell("gaussian").metrics["theta_mse"] > 0.0)


def test_summary_statistics_and_json(port_results):
    result = port_results["byzantine"]
    cell = result.cell("gaussian")
    assert cell.metrics["acc"].shape == (len(SEEDS), BASE["rounds"])
    mean, half = cell.trajectory("acc")
    assert mean.shape == (BASE["rounds"],) and half.shape == (BASE["rounds"],)
    final_mean, final_half = cell.final("acc")
    assert 0.0 <= final_mean <= 1.0 and final_half >= 0.0
    js = result.to_json()
    assert set(js["cells"]) == {name for name, _ in CELLS}
    g = js["groups"][0]
    assert g["backend"] == "cpu" and g["kernel_engine"] == "torch" and g["n_elems"] == 3 * len(SEEDS)
    rows = list(result.emit_rows("t"))
    assert len(rows) == len(CELLS) and rows[0][0] == "t_gaussian" and rows[0][1] > 0


def test_group_signature_splits_static_fields():
    sig = lambda **kw: tsim.group_signature(FLConfig(**{**BASE, **kw}))  # noqa: E731
    assert sig(attack="gaussian") == sig(attack="bit_flip", lr=0.05, seed=3)
    assert sig() != sig(aggregator="fedavg")
    assert sig() != sig(n_clients=8)
    assert sig() != sig(dp_epsilon=0.1)


def test_from_grid_cartesian():
    spec = tsim.CampaignSpec.from_grid(BASE, {"attack": ["gaussian", "alie"], "lr": [0.01, 0.02]}, seeds=(0,))
    assert [c.name for c in spec.cells] == [
        "attack=gaussian|lr=0.01", "attack=gaussian|lr=0.02", "attack=alie|lr=0.01", "attack=alie|lr=0.02",
    ]
    assert len({tsim.group_signature(c) for c in spec.configs()}) == 1


def test_sim_exports_the_reference_api():
    assert sorted(tsim.__all__) == sorted(jsim.__all__)


@pytest.mark.parametrize("cells,kw", [
    # repair 1: the latency and decay come from each run, not the group's config
    ((("lat0.5", {"async_latency": 0.5}), ("lat2", {"async_latency": 2.0, "staleness_decay": 1.0})),
     dict(n_clients=6, rounds=3, local_epochs=1, async_buffer=6, b_mode="fixed")),
    # repair 2: the bit_flip cell arms the group's wire flip; its gaussian
    # neighbour's gate keeps its wire honest (kernel wire, dense and async)
    ((("gaussian", {"attack": "gaussian"}), ("bit_flip", {"attack": "bit_flip"})),
     dict(n_clients=6, rounds=2, local_epochs=1, byz_frac=0.34, use_kernels=True)),
    ((("fedavg_gauss", {"attack": "gaussian"}), ("fedavg_flip", {"attack": "bit_flip"})),
     dict(n_clients=6, rounds=2, local_epochs=1, byz_frac=0.34, aggregator="fedavg")),
    ((("async_sign", {"attack": "straggler+sign_flip"}), ("async_flip", {"attack": "straggler+bit_flip"})),
     dict(n_clients=6, rounds=3, local_epochs=1, byz_frac=0.34, async_buffer=3, async_latency=1.0)),
], ids=["latency", "bit_flip_vs_gaussian", "fedavg_bit_flip", "async_straggler_bit_flip"])
def test_per_run_knobs_in_a_shared_group(cells, kw):
    """Cells that differ only in a per-run knob share one group and each
    still gives its own sequential run's results."""
    spec = tsim.CampaignSpec(base=kw, cells=tuple(tsim.CellSpec(n, o) for n, o in cells), seeds=SEEDS)
    result = tsim.run_campaign(spec, lambda cfg: _ttask(cfg.n_clients), compile_cache=tsim.CompileCache())
    assert len(result.groups) == 1
    for name, over in cells:
        _assert_matches_sequential(result, name, {**kw, **over}, _ttask(kw["n_clients"]))


def test_tasks_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cx, cy, test = _data(6)
    task = tsim.Task(_p0(), None, None, cx, cy, test)
    spec = tsim.CampaignSpec(base=dict(n_clients=6, rounds=1), cells=(tsim.CellSpec("a"),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.run_campaign(spec, lambda cfg: task, compile_cache=tsim.CompileCache())
