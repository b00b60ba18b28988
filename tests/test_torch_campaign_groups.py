"""The asynchronous and streamed campaign groups run as one group of E
runs, as the reference's ``jax.vmap(cell_fn)`` does.

Three groups of E = 3 runs go through the port's ``run_campaign``: an
asynchronous group (B = 3 slots of M = 6, the cells differing in latency,
decay and attack, one armed with the straggler gate), a streamed group
(chunks of 4 that do not divide the cohort of 6, error feedback, the cells
differing in attack, lr, momentum and b_init) and a fused M-sweep (M in
{3, 5, 6}) that the planner streams in chunks of 4, each run masked to its
own cohort. Each group's rounds run once, with a leading E on keys and
state. Each run equals
its sequential ``FLSimulation`` run of the port (b exact, loss rtol 1e-6,
accuracy 1e-6) and the JAX package's ``run_campaign`` on the same cells
(b exact, loss rtol 1e-4 and accuracy within one test sample, the bars of
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
from repro_torch.sim import batched  # noqa: E402
from repro_torch.sim import campaign as tcampaign  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

SEEDS = (0,)
N_TEST = 150
GROUPS = {
    "async": (dict(n_clients=6, rounds=3, local_epochs=1, byz_frac=0.34, async_buffer=3, async_latency=1.0,
                   use_kernels=True),
              (("a_gauss", {"attack": "gaussian"}),
               ("a_decay", {"attack": "sign_flip", "async_latency": 0.5, "staleness_decay": 0.5}),
               ("a_straggler", {"attack": "straggler+sign_flip", "staleness_decay": 1.0}))),
    "stream": (dict(n_clients=6, rounds=3, local_epochs=1, byz_frac=0.34, client_chunk=4, error_feedback=True,
                    use_kernels=True),
               (("s_gauss", {"attack": "gaussian"}),
                ("s_sign", {"attack": "sign_flip", "lr": 0.02}),
                ("s_mom", {"attack": "bit_flip", "momentum": 0.5, "b_init": 0.02}))),
    "fused_stream": (dict(rounds=3, local_epochs=1, batch_size=10, use_kernels=True),
                     tuple((f"M{m}", {"n_clients": m}) for m in (3, 5, 6))),
}
# the fused M-sweep's padded cohort of 6 streams in chunks of 4
PLAN_KW = {"fused_stream": dict(stream_threshold=4, stream_chunk=4)}


@functools.lru_cache(maxsize=None)
def _data(m: int):
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=N_TEST)
    parts = partition_label_skew(ytr, m, 2, 50, seed=1)
    return np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts]), {"x": xte, "y": yte}


@functools.lru_cache(maxsize=None)
def _p0():
    return jax.tree_util.tree_map(np.asarray, jv.init_mlp(jax.random.PRNGKey(0), hidden=8))


def _jtask(m: int):
    cx, cy, test = _data(m)
    return jsim.Task(_p0(), functools.partial(jv.xent_loss, jv.mlp_logits),
                     functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)


@functools.lru_cache(maxsize=None)
def _ttask(m: int):
    cx, cy, test = _data(m)
    return tsim.Task(_p0(), functools.partial(tv.xent_loss, tv.mlp_logits),
                     functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")


def _spec(mod, name):
    base, cells = GROUPS[name]
    return mod.CampaignSpec(base=base, cells=tuple(mod.CellSpec(n, o) for n, o in cells), seeds=SEEDS)


@pytest.fixture(scope="module")
def port_results():
    """Each group through the port's run_campaign, with the key shapes its
    rounds were run with."""
    out = {}
    orig = tcampaign.R.run_rounds
    for name in GROUPS:
        calls = []

        def spy(ctx, params, key, state, *a, **kw):
            calls.append((tuple(key.shape), tuple(state.w_global.shape)))
            return orig(ctx, params, key, state, *a, **kw)

        spec = _spec(tsim, name)
        tcampaign.R.run_rounds = spy
        try:
            res = tsim.run_campaign(spec, lambda cfg: _ttask(cfg.n_clients), compile_cache=tsim.CompileCache(),
                                    plan=tsim.plan_campaign(spec, **PLAN_KW.get(name, {})))
        finally:
            tcampaign.R.run_rounds = orig
        out[name] = (res, calls)
    return out


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name in GROUPS:
        spec = _spec(jsim, name)
        out[name] = jsim.run_campaign(spec, lambda cfg: _jtask(cfg.n_clients), compile_cache=jsim.CompileCache(),
                                      plan=jsim.plan_campaign(spec, **PLAN_KW.get(name, {})))
    return out


@pytest.mark.parametrize("name", list(GROUPS))
def test_group_runs_as_one_group(port_results, name):
    """One group, its rounds run once with keys (E, 2) and a state of
    leading E."""
    res, calls = port_results[name]
    e = len(GROUPS[name][1]) * len(SEEDS)
    assert len(res.groups) == 1
    assert [(k, w[0]) for k, w in calls] == [((e, 2), e)]
    if name == "fused_stream":
        assert res.groups[0]["fused"] and res.groups[0]["client_chunk"] == 4


@pytest.mark.parametrize("name,cell", [(g, c) for g, (_, cells) in GROUPS.items() for c, _ in cells])
def test_group_run_equals_sequential_run(port_results, name, cell):
    base, cells = GROUPS[name]
    kw = {**base, **dict(cells)[cell]}
    task = _ttask(kw["n_clients"])
    got = port_results[name][0].cell(cell).metrics
    for si, seed in enumerate(SEEDS):
        sim = FLSimulation(FLConfig(seed=seed, **kw), task.init_params, task.loss_fn, task.acc_fn,
                           task.client_x, task.client_y, task.test, device="cpu")
        sim.run(eval_every=1)
        want = {k: np.asarray([h[k] for h in sim.history]) for k in ("acc", "loss", "b")}
        np.testing.assert_array_equal(got["b"][si], want["b"].astype(np.float32), err_msg=cell)
        np.testing.assert_allclose(got["loss"][si], want["loss"], rtol=1e-6, err_msg=cell)
        np.testing.assert_allclose(got["acc"][si], want["acc"], atol=1e-6, err_msg=cell)


@pytest.mark.parametrize("name,cell", [(g, c) for g, (_, cells) in GROUPS.items() for c, _ in cells])
def test_group_run_equals_reference_campaign(port_results, jax_results, name, cell):
    got, want = port_results[name][0].cell(cell).metrics, jax_results[name].cell(cell).metrics
    np.testing.assert_array_equal(got["b"], np.asarray(want["b"]))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert np.abs(got["acc"] - want["acc"]).max() <= 1.0 / N_TEST + 1e-7
    for k in ("buf_fill", "mean_age"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1.2e-7)


def test_batchable_groups():
    """Every kind of group batches: the asynchronous and streamed rounds,
    and trees, sharded streamed cohorts and the k-bit, mixed-width and
    top-k wires (the five that ran one run at a time before), each a state
    of leading E = 2 that runs one round as a group (keys (2, 2)) and
    gives (2,) metrics."""
    task = _ttask(6)
    for kw in (GROUPS["async"][0], GROUPS["stream"][0], dict(client_chunk=2, tree_edges=2),
               dict(client_chunk=2, stream_shard=True, stateless_clients=True), dict(wire_bits=2),
               dict(client_bits=(1, 2, 1, 2, 1, 2)), dict(topk_frac=0.5)):
        cfg = FLConfig(**{"n_clients": 6, **kw})
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "stream_shard is a no-op", RuntimeWarning)
            ctx = tcampaign.R.make_context(cfg, task.init_params, task.loss_fn, task.acc_fn, task.client_x,
                                           task.client_y, task.test, device="cpu")
        params, keys, state = tcampaign._batched_inputs(ctx, [cfg], (0, 1))
        assert state.w_global.shape == (2, ctx.d), kw
        final, traj = tcampaign.R.run_rounds(ctx, batched.device_params(params, ctx.device), keys, state, rounds=1)
        assert final.w_global.shape == (2, ctx.d) and traj["b"].shape == (2, 1), kw
