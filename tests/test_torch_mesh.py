"""The port's mesh layer (repro_torch.distributed, repro_torch.launch.mesh)
and the LM round's pod axis, on the CPU.

``spec_for`` equals the reference's ``repro.distributed.spec_for`` on the
same mesh sizes for every logical name, the divisibility drop and the rule
that one mesh axis serves one dimension included. The mesh constructors
refuse what they cannot build. The LM step with ``n_pods = 2`` in one
process equals the jitted reference's step on the same (2, 2) batch at a
micro qwen2 with f32 parameters (new parameters and b bit for bit, losses
within rtol 1e-6, the bars of tests/test_torch_fl_step.py) and the same
clients laid out (4, 1) (parameters and b bit for bit; the losses average
in another order); over 2 gloo pod ranks (one module-scoped spawn,
``tests/_torch_ranks.py``) every rank's step equals the one-process step
bit for bit.
"""

import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed as jdist
from repro import configs as jc
from repro.distributed import set_mesh as j_set_mesh
from repro.launch import fl_step as jfs
from repro.launch.mesh import make_host_mesh
from repro.models import build_specs as jbs
from repro.models.spec import init_params as jip
from repro.models.spec import param_pspecs
from repro_torch import configs as tc
from repro_torch import distributed, prng, tree
from repro_torch.data import make_lm_streams
from repro_torch.launch import fl_step as tfs
from repro_torch.launch import mesh as tmesh

from _torch_ranks import run_ranks

# (mesh shape, axis names) the rules are held on, the reference's production
# layouts among them
MESHES = [
    ((2, 2), ("data", "model")),
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((4, 1, 8), ("pod", "data", "model")),
]
NAMES = (None, "unknown", "batch", "batch_pod", "clients", "seq", "heads", "kv", "ff", "vocab", "experts")
DIMS = (1, 2, 3, 4, 8, 12, 24, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_spec(shape, axes, logical, dims):
    fake = types.SimpleNamespace(axis_names=axes, axis_sizes=shape, empty=False)
    old = jdist.current_mesh
    jdist.current_mesh = lambda: fake
    try:
        return tuple(jdist.spec_for(logical, dims))
    finally:
        jdist.current_mesh = old


@pytest.mark.parametrize("shape,axes", MESHES, ids=lambda v: "x".join(map(str, v)) if isinstance(v[0], int) else None)
def test_spec_for_equals_reference(shape, axes):
    """Every logical name alone and every pair of names, at dimensions that
    divide the mesh axes and that do not; under the default batch axes, the
    serving batch axes ("pod", "data") and a rule override."""
    fake = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    cases = [((n,), (d,)) for n in NAMES for d in DIMS]
    cases += [(pair, dims) for pair in itertools.product(NAMES, repeat=2) for dims in ((8, 8), (3, 16), (32, 12))]
    for ctx_j, ctx_t in (
        (lambda: jdist.use_batch_axes("data"), lambda: distributed.use_batch_axes("data")),
        (lambda: jdist.use_batch_axes("pod", "data"), lambda: distributed.use_batch_axes("pod", "data")),
        (lambda: jdist.use_rules(heads=("model", "data")), lambda: distributed.use_rules(heads=("model", "data"))),
    ):
        for logical, dims in cases:
            with ctx_j():
                want = _reference_spec(shape, axes, logical, dims)
            with ctx_t(), distributed.set_mesh(fake):
                got = distributed.spec_for(logical, dims)
            assert got == want, (logical, dims, got, want)


def test_spec_rules_without_a_mesh_and_the_drops():
    """No mesh: an empty spec and ``shard`` a no-op; the reference's own
    drops (tests/test_distributed.py) and the DTensor placements."""
    from torch.distributed.tensor import Replicate, Shard

    x = torch.ones(3, 4)
    assert distributed.spec_for(("heads", None), (3, 4)) == () and distributed.shard(x, "heads", None) is x
    fake = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    with distributed.set_mesh(fake):
        assert distributed.spec_for(("heads",), (3,)) == (None,)
        assert distributed.spec_for(("heads",), (4,)) == ("model",)
        assert distributed.spec_for(("seq", "kv"), (8, 8)) == ("model", None)
        assert distributed.shard(x, "heads", None) is x  # a plain tensor stays as it is
        with pytest.raises(ValueError, match="logical axes"):
            distributed.shard(x, "heads")
    assert distributed.current_mesh() is None
    assert distributed.placements_for(fake, ("batch", "heads"), (4, 6)) == (Shard(0), Shard(1))
    assert distributed.placements_for(fake, ("heads", None), (3, 6)) == (Replicate(), Replicate())
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data"), shape=(2, 2))
    with distributed.use_batch_axes("pod", "data"):
        assert distributed.placements_for(pod, ("batch",), (8,)) == (Shard(0), Shard(0))


def test_meshes_refuse_what_they_cannot_build():
    """Without a process group every constructor raises a clear error; the
    production mesh names the world it needs; the client axis has no
    group."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((2,), ("data",), "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_campaign_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh()
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"world of {need} ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
    assert distributed.client_group() is None and distributed.group_size(None) == 1
    with pytest.raises(ValueError, match="pods"):
        with distributed.set_mesh(types.SimpleNamespace(mesh_dim_names=("pod",), shape=(3,))):
            tfs._pod_group(2)


M_SEQ, N_PODS, L, PB, S = 2, 2, 2, 2, 16
FL = dict(clients_per_round=M_SEQ * N_PODS, local_steps=L)


def micro(configs):
    return dataclasses.replace(configs.get_config("qwen2-1.5b"), name="qwen2-micro", n_layers=2, d_model=32,
                               n_heads=2, n_kv_heads=1, d_ff=64, vocab=64, d_head=16)


@pytest.fixture(scope="module")
def lm():
    """The micro qwen2's f32 parameters (the reference's, as numpy), one
    round's tokens of 4 clients and the round key."""
    cfg = micro(jc)
    with j_set_mesh(make_host_mesh()):
        jp = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jip(jbs(cfg), jax.random.PRNGKey(0)))
    streams = make_lm_streams(0, M_SEQ * N_PODS, cfg.vocab, S + 1, L * PB)
    toks = np.stack([s.reshape(L, PB, S + 1) for s in streams])  # client g's sequences
    return jp, toks


def _batch(toks, m_seq, n_pods, lib):
    """Client g at scan step g // n_pods, pod g % n_pods."""
    t = toks.reshape((m_seq, n_pods) + toks.shape[1:])
    return {"tokens": lib(t[..., :-1]), "labels": lib(t[..., 1:])}


def _port_step(lm, m_seq, n_pods, aggregator="probit_plus"):
    jp, toks = lm
    step = tfs.make_fl_train_step(micro(tc), tfs.DistFLConfig(**FL, aggregator=aggregator))
    params = tree.tree_map(lambda a: torch.from_numpy(a.copy()), jp)
    _, kr = prng.split(prng.key(1), 2)
    return step(params, torch.tensor(0.01), _batch(toks, m_seq, n_pods, torch.from_numpy), kr)


def test_pod_step_in_one_process_equals_reference(lm):
    """n_pods = 2 without a mesh runs the reference's vmap over pods as a
    loop: new parameters and b equal the jitted reference's bit for bit,
    the losses within rtol 1e-6."""
    jp, toks = lm
    cfg = micro(jc)
    with j_set_mesh(make_host_mesh()):
        jstep = jax.jit(jfs.make_fl_train_step(cfg, jfs.DistFLConfig(**FL), param_pspecs(jbs(cfg))))
        _, jkr = jax.random.split(jax.random.PRNGKey(1))
        jnew, jb, jm = jstep(jax.tree.map(jnp.asarray, jp), jnp.float32(0.01),
                             _batch(toks, M_SEQ, N_PODS, jnp.asarray), jkr)
    new, b, m = _port_step(lm, M_SEQ, N_PODS)
    for a, c in zip(jax.tree.leaves(jnew), tree.leaves(new)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    assert float(b) == float(jb)
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("aggregator", ["probit_plus", "fedavg_fp32"])
def test_pod_layout_equals_one_pod_layout(lm, aggregator):
    """The same 4 clients as (2, 2) and as (4, 1): each client trains at
    the same cohort position, so PRoBit+'s new parameters and b are the
    same bits (FedAvg's sums of model differences add the pods' partial
    sums, rtol 1e-6); the loss means (over pods, then over steps) within
    rtol 1e-6."""
    new, b, m = _port_step(lm, M_SEQ, N_PODS, aggregator)
    new1, b1, m1 = _port_step(lm, M_SEQ * N_PODS, 1, aggregator)
    for a, c in zip(tree.leaves(new), tree.leaves(new1)):
        if aggregator == "probit_plus":
            assert torch.equal(a, c)
        else:
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6, atol=1e-8)
    assert float(b) == float(b1)
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(float(m[k]), float(m1[k]), rtol=1e-6)
    assert m["wire_bytes"] == m1["wire_bytes"]


@pytest.fixture(scope="module")
def pod_ranks(lm, tmp_path_factory):
    """The step of each aggregator over a ("pod",) mesh of 2 gloo ranks,
    each on the whole batch."""
    jp, toks = lm
    _, kr = prng.split(prng.key(1), 2)
    kw = dict(cfg=micro(tc), params=tree.tree_map(lambda a: torch.from_numpy(a.copy()), jp), b=0.01, key=kr,
              batch=_batch(toks, M_SEQ, N_PODS, torch.from_numpy))
    return run_ranks(N_PODS, tmp_path_factory.mktemp("pods"), "several",
                     **{agg: ("lm_pod_step", dict(kw, fl=dict(FL, aggregator=agg)))
                        for agg in ("probit_plus", "fedavg_fp32")})


@pytest.mark.parametrize("aggregator", ["probit_plus", "fedavg_fp32"])
def test_pod_ranks_equal_one_process(lm, pod_ranks, aggregator):
    """Every pod rank's new parameters, b and losses equal the one-process
    step's bit for bit; the ranks' collectives: one gather of the rows (or
    one sum of the model differences) a leaf, the vote sum and the loss
    gather."""
    new, b, m = _port_step(lm, M_SEQ, N_PODS, aggregator)
    n_leaves = len(tree.leaves(new))
    for r in (ranks[aggregator] for ranks in pod_ranks):
        for a, c in zip(r["params"], tree.leaves(new)):
            assert torch.equal(a, c)
        assert r["b"] == float(b)
        assert r["metrics"] == {k: float(v) for k, v in m.items()}
        assert r["collectives"]["calls"] == n_leaves + 2
