"""The port's client axis over gloo ranks on the CPU: ``stream_shard``,
``tree_shard`` and ``run_campaign(shard=True)``, against the port's own
one-process runs and the JAX package's.

One module fixture spawns 4 ranks (``tests/_torch_ranks.py``); each runs
every sharded configuration over the world, then a sharded campaign over
the ``"data"`` dimension (2 ranks) of a (2, 2) mesh. Against the port's
unsharded runs: the count schemes' models, b, estimates and losses equal
bit for bit (vote, count and weight sums are integers, the chunks' loss
sums are added in chunk order), ``theta_mse`` within rtol 1e-6 (its delta
sum crosses ranks as a sum); a chunk that does not divide a rank's block
(the weighted path) and FedAvg's sums within rtol 1e-6; the sharded trees
equal in every metric (the edges come back whole and merge as in one
process); the campaign's b exact and losses within rtol 1e-6 (equal here).
Against the reference's ``FLSimulation`` with the same flags on its one
CPU device (its one-device no-op, the unsharded scan and host-loop edge
sweep): the bars of ``tests/test_torch_kbit.py::_hold``, and at lr = 0,
where every client uploads a zero delta and only the quantizer's Threefry
bits vote, the vote counts, so the models and b, exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax

import repro  # noqa: F401
from repro.data import make_classification, partition_label_skew
from repro.fl import FLConfig as JConfig
from repro.fl import FLSimulation as JSim
from repro.models import vision as jv
from repro_torch.fl import FLConfig, FLSimulation
from repro_torch.models import vision as tv
from repro_torch.sim import CampaignSpec, CellSpec, CompileCache, Task, run_campaign

from _torch_ranks import run_ranks

WORLD, N, ROUNDS = 4, 8, 2
BASE = dict(n_clients=N, rounds=ROUNDS, local_epochs=1, batch_size=10, use_kernels=True, stateless_clients=True)
STREAM = {
    "probit": dict(client_chunk=1),
    "probit_lr0": dict(client_chunk=1, lr=0.0),
    "probit_weighted": dict(client_chunk=3),
    "fedavg": dict(aggregator="fedavg", client_chunk=2),
}
TREE = {
    "tree": dict(tree_edges=4, client_chunk=2),
    "tree_median": dict(tree_edges=8, client_chunk=2, edge_merge="median", byz_edges=1,
                        edge_attack="edge_sign_flip"),
}
SHARDED = {**{k: dict(BASE, stream_shard=True, **v) for k, v in STREAM.items()},
           **{k: dict(BASE, tree_shard=True, **v) for k, v in TREE.items()}}
# FLConfig fields of the unsharded twin of each sharded config
UNSHARDED = {k: {f: v for f, v in cfg.items() if f not in ("stream_shard", "tree_shard")} for k, cfg in SHARDED.items()}
CAMPAIGN = dict(base=dict(n_clients=N, rounds=ROUNDS, local_epochs=1, use_kernels=True),
                cells=[("sync", {}), ("async", {"async_buffer": 4, "async_latency": 1.0, "staleness_decay": 0.5})],
                seeds=(0, 1, 2))
MESH = ((2, 2), ("pod", "data"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _task():
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=100)
    parts = partition_label_skew(ytr, N, 2, 30, seed=1)
    p0 = jax.tree_util.tree_map(np.asarray, jv.init_mlp(jax.random.PRNGKey(0), hidden=8))
    return p0, np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts]), {"x": xte, "y": yte}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: the sharded configs over 4 ranks, then the
    campaign over the mesh's 2-rank "data" dimension."""
    task = _task()
    return run_ranks(WORLD, tmp_path_factory.mktemp("shard"), "several",
                     fl=("fl_runs", dict(cfgs=SHARDED, task=task, rounds=ROUNDS)),
                     campaign=("campaign", dict(**CAMPAIGN, task=task, mesh=MESH)))


@functools.lru_cache(maxsize=None)
def _port(name):
    """The port's one-process run of a config's unsharded twin."""
    p0, cx, cy, test = _task()
    sim = FLSimulation(FLConfig(**UNSHARDED[name]), p0, functools.partial(tv.xent_loss, tv.mlp_logits),
                       functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")
    return [{k: v.clone() for k, v in m.items()} for _, m in sim.iter_rounds(ROUNDS)], sim.w_global.clone()


def _reference(name):
    """The reference's FLSimulation of the sharded config itself on its one
    CPU device: each round's loss and b, and the final model."""
    p0, cx, cy, test = _task()
    with pytest.warns(RuntimeWarning, match="is a no-op: only one local device is visible"):
        sim = JSim(JConfig(**SHARDED[name]), p0, functools.partial(jv.xent_loss, jv.mlp_logits),
                   functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)
    hist = sim.run(eval_every=1)
    return hist, np.asarray(sim.w_global)


@pytest.mark.parametrize("name", list(SHARDED))
def test_every_rank_ran_its_block_and_agrees(ranks, name):
    """Each rank ran sharded over the 4 ranks, held only its 2 clients' data,
    and ends with the same model and metrics as every other rank."""
    runs = [r["fl"][name] for r in ranks]
    tree = name.startswith("tree")
    for k, run in enumerate(runs):
        assert run["ranks"] == WORLD and run["tree_ranks"] == (WORLD if tree else 1)
        assert run["client_rows"] == N // WORLD and run["data_offset"] == k * N // WORLD
        assert torch.equal(run["w_global"], runs[0]["w_global"])
        for a, c in zip(run["metrics"], runs[0]["metrics"]):
            assert all(torch.equal(a[m], c[m]) for m in a)


@pytest.mark.parametrize("name", ["probit", "probit_lr0", "tree", "tree_median"])
def test_sharded_counts_equal_one_process(ranks, name):
    """Count schemes: models, b, estimates and losses bit for bit with the
    one-process run; a stream's theta_mse within rtol 1e-6, a tree's exact."""
    run, (mets, w) = ranks[0]["fl"][name], _port(name)
    assert torch.equal(run["w_global"], w)
    for a, c in zip(run["metrics"], mets):
        assert set(a) == set(c)
        for m in a:
            if m == "theta_mse" and not name.startswith("tree"):
                np.testing.assert_allclose(a[m].numpy(), c[m].numpy(), rtol=1e-6)
            else:
                assert torch.equal(a[m], c[m]), m


@pytest.mark.parametrize("name", ["probit_weighted", "fedavg"])
def test_sharded_weighted_and_sum_kinds_equal_one_process(ranks, name):
    """A chunk that does not divide a rank's block (weighted counts: still
    integers, so b and the estimate exact) and FedAvg's sums: rtol 1e-6."""
    run, (mets, w) = ranks[0]["fl"][name], _port(name)
    exact = name == "probit_weighted"
    np.testing.assert_allclose(run["w_global"].numpy(), w.numpy(), rtol=0 if exact else 1e-6, atol=0 if exact else 1e-7)
    for a, c in zip(run["metrics"], mets):
        assert float(a["b"]) == float(c["b"])
        for m in ("loss", "theta_mse", "theta"):
            np.testing.assert_allclose(a[m].numpy(), c[m].numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["probit", "tree"])
def test_sharded_against_reference(ranks, name):
    """Against the reference's run of the same config (its no-op on one
    device): b exact every round, the loss within rtol 1e-6 and w_global
    within 1e-5 but for at most 0.1% of the coordinates (``_hold``'s bars:
    XLA contracts the prox step into FMAs)."""
    run = ranks[0]["fl"][name]
    hist, w = _reference(name)
    assert [float(m["b"]) for m in run["metrics"]] == [h["b"] for h in hist]
    np.testing.assert_allclose([float(m["loss"]) for m in run["metrics"]], [h["loss"] for h in hist], rtol=1e-6)
    diff = np.abs(run["w_global"].numpy() - w)
    assert (diff > 1e-5).sum() <= 0.001 * diff.size, diff.max()


@pytest.mark.parametrize("name", ["probit_lr0"])
def test_sharded_vote_counts_equal_reference_at_lr0(ranks, name):
    """At lr = 0 every delta is 0 in both packages, so every vote is a
    Threefry bit: the summed counts, so the models and b, equal the
    reference's exactly; the loss within rtol 1e-6."""
    run = ranks[0]["fl"][name]
    hist, w = _reference(name)
    np.testing.assert_array_equal(run["w_global"].numpy(), w)
    assert [float(m["b"]) for m in run["metrics"]] == [h["b"] for h in hist]
    np.testing.assert_allclose([float(m["loss"]) for m in run["metrics"]], [h["loss"] for h in hist], rtol=1e-6)


def test_sharded_campaign_equals_unsharded(ranks):
    """run_campaign(shard=True) over the mesh's 2-rank "data" dimension:
    every group reports 2 devices and its 3 runs padded to 4; every rank
    assembles the same cells, each with b equal to the unsharded
    campaign's and the loss within rtol 1e-6 (equal here)."""
    p0, cx, cy, test = _task()
    task = Task(p0, functools.partial(tv.xent_loss, tv.mlp_logits), functools.partial(tv.accuracy, tv.mlp_logits),
                cx, cy, test, device="cpu")
    spec = CampaignSpec(base=CAMPAIGN["base"], cells=tuple(CellSpec(n, o) for n, o in CAMPAIGN["cells"]),
                        seeds=CAMPAIGN["seeds"])
    plain = run_campaign(spec, lambda cfg: task, compile_cache=CompileCache())
    for r in ranks:
        got = r["campaign"]
        assert [(g["n_devices"], g["n_elems"], g["n_elems_padded"]) for g in got["groups"]] == [(2, 3, 4)] * 2
        for cell in plain.cells:
            mine = got["cells"][cell.name]
            np.testing.assert_array_equal(mine["b"], cell.metrics["b"])
            np.testing.assert_allclose(mine["loss"], cell.metrics["loss"], rtol=1e-6)
            np.testing.assert_array_equal(mine["loss"], cell.metrics["loss"])
