"""The tree, k-bit, mixed-width, top-k and sharded-cohort campaign groups
run as one group of E runs, as the reference's ``jax.vmap(cell_fn)`` does.

Nine groups of E = 3 runs go through the port's ``run_campaign``: the
2-bit wire, the 4-bit wire under DP (randomized response), a mixed-width
cohort, the top-k wire with and without error feedback (its gathered
values on the pack kernel's wire), a sum tree of 4 edges over a cohort of
6 (the edges do not divide it), a median tree of 3 edges whose first edge
is Byzantine, a buffered tree whose runs differ in latency and decay, and
a ``stream_shard`` group on one rank (the streamed form). The cells of a
group differ in the per-run knobs (lr, momentum, b_init, attack, latency,
decay). Each group's rounds run once, with keys (E, 2). Each run equals
its sequential ``FLSimulation`` run of the port (b exact, loss rtol 1e-6,
accuracy 1e-6, and the final model bit for bit: every count of these
wires is an integer, and every float step of a run is taken on its own
rows) and the JAX package's ``run_campaign`` on the same cells (b exact,
loss rtol 1e-4 and accuracy within one test sample, the bars of
``tests/test_torch_campaign.py``).
"""

import functools
import warnings

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
from repro_torch.sim import campaign as tcampaign  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

M, N_TEST = 6, 150
BASE = dict(n_clients=M, rounds=2, local_epochs=1, batch_size=10)
KNOBS = (("lr", {"lr": 0.02}), ("mom", {"momentum": 0.5, "b_init": 0.02}), ("plain", {}))
BYZ = (("gauss", {"attack": "gaussian"}), ("sign", {"attack": "sign_flip", "lr": 0.02}),
       ("mom", {"attack": "gaussian", "momentum": 0.5, "b_init": 0.02}))
TREE = dict(client_chunk=2, use_kernels=True)
GROUPS = {
    "kbit2": (dict(BASE, wire_bits=2, use_kernels=True, byz_frac=0.34), BYZ),
    "kbit4_dp": (dict(BASE, wire_bits=4, dp_epsilon=2.0), KNOBS),
    "mixed": (dict(BASE, client_bits=(1, 2, 2, 4, 4, 1)), KNOBS),
    "topk": (dict(BASE, topk_frac=0.3, use_kernels=True, byz_frac=0.34), BYZ),
    "topk_ef": (dict(BASE, topk_frac=0.3, use_kernels=True, error_feedback=True), KNOBS),
    "tree_sum": (dict(BASE, tree_edges=4, **TREE), KNOBS),
    "tree_median": (dict(BASE, tree_edges=3, edge_merge="median", byz_edges=1, edge_attack="edge_sign_flip", **TREE),
                    KNOBS),
    "tree_buf": (dict(BASE, tree_edges=3, edge_buffer=2, async_latency=1.0, **TREE),
                 (("slow", {"async_latency": 2.0}), ("decay", {"staleness_decay": 0.5}),
                  ("both", {"async_latency": 0.5, "staleness_decay": 1.0, "lr": 0.02}))),
    "stream_shard": (dict(BASE, client_chunk=4, stateless_clients=True, stream_shard=True, use_kernels=True), KNOBS),
}
CELLS = [(g, c) for g, (_, cells) in GROUPS.items() for c, _ in cells]


@functools.lru_cache(maxsize=None)
def _data():
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=N_TEST)
    parts = partition_label_skew(ytr, M, 2, 50, seed=1)
    return np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts]), {"x": xte, "y": yte}


@functools.lru_cache(maxsize=None)
def _p0():
    return jax.tree_util.tree_map(np.asarray, jv.init_mlp(jax.random.PRNGKey(0), hidden=8))


@functools.lru_cache(maxsize=None)
def _ttask():
    cx, cy, test = _data()
    return tsim.Task(_p0(), functools.partial(tv.xent_loss, tv.mlp_logits),
                     functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")


def _jtask():
    cx, cy, test = _data()
    return jsim.Task(_p0(), functools.partial(jv.xent_loss, jv.mlp_logits),
                     functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)


def _spec(mod, name):
    base, cells = GROUPS[name]
    return mod.CampaignSpec(base=base, cells=tuple(mod.CellSpec(n, o) for n, o in cells), seeds=(0,))


def _quiet(fn):
    """``fn()`` with the one-device ``stream_shard`` no-op's warning muted."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "stream_shard is a no-op", RuntimeWarning)
        return fn()


@pytest.fixture(scope="module")
def port_results():
    """Each group through the port's run_campaign: the result, the key
    shapes its rounds ran with and the runs' final global models."""
    out = {}
    orig = tcampaign.R.run_rounds
    for name in GROUPS:
        calls = []

        def spy(ctx, params, key, state, *a, **kw):
            final, traj = orig(ctx, params, key, state, *a, **kw)
            calls.append((tuple(key.shape), final.w_global.clone()))
            return final, traj

        tcampaign.R.run_rounds = spy
        try:
            res = _quiet(lambda: tsim.run_campaign(_spec(tsim, name), lambda cfg: _ttask(),
                                                   compile_cache=tsim.CompileCache()))
        finally:
            tcampaign.R.run_rounds = orig
        out[name] = (res, calls)
    return out


@pytest.fixture(scope="module")
def jax_results():
    return {name: _quiet(lambda: jsim.run_campaign(_spec(jsim, name), lambda cfg: _jtask(),
                                                   compile_cache=jsim.CompileCache()))
            for name in GROUPS}


@pytest.mark.parametrize("name", list(GROUPS))
def test_group_runs_as_one_group(port_results, name):
    """One group, its rounds run once with keys (E, 2)."""
    res, calls = port_results[name]
    assert len(res.groups) == 1
    assert [shape for shape, _ in calls] == [(len(GROUPS[name][1]), 2)]


@pytest.mark.parametrize("name,cell", CELLS)
def test_group_run_equals_sequential_run(port_results, name, cell):
    base, cells = GROUPS[name]
    task = _ttask()
    res, calls = port_results[name]
    got = res.cell(cell).metrics
    sim = _quiet(lambda: FLSimulation(FLConfig(seed=0, **{**base, **dict(cells)[cell]}), task.init_params,
                                      task.loss_fn, task.acc_fn, task.client_x, task.client_y, task.test,
                                      device="cpu"))
    sim.run(eval_every=1)
    want = {k: np.asarray([h[k] for h in sim.history]) for k in ("acc", "loss", "b")}
    np.testing.assert_array_equal(got["b"][0], want["b"].astype(np.float32), err_msg=cell)
    np.testing.assert_allclose(got["loss"][0], want["loss"], rtol=1e-6, err_msg=cell)
    np.testing.assert_allclose(got["acc"][0], want["acc"], atol=1e-6, err_msg=cell)
    run = [c for c, _ in cells].index(cell)
    assert torch.equal(calls[0][1][run], sim.w_global), cell


@pytest.mark.parametrize("name,cell", CELLS)
def test_group_run_equals_reference_campaign(port_results, jax_results, name, cell):
    got, want = port_results[name][0].cell(cell).metrics, jax_results[name].cell(cell).metrics
    np.testing.assert_array_equal(got["b"], np.asarray(want["b"]))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert np.abs(got["acc"] - want["acc"]).max() <= 1.0 / N_TEST + 1e-7
    for k in ("buf_fill", "mean_age", "edge_mass_min"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1.2e-7)
