"""The port's model axis (ROADMAP A14b) on the CPU.

The sharding metadata equals the reference's exactly: ``param_pspecs``
(with and without the FSDP rule over "data") for every architecture of the
registry on the full-size spec trees on (16, 16), (2, 16, 16), (2, 2) and
(1, 2) meshes (nothing allocated; the reference through the monkeypatched
``current_mesh`` of tests/test_distributed.py), ``abstract_params``,
``input_specs`` / ``input_logical`` of every kind and ``cache_logical``.
The remat levers change no gradient bit. ``make_production_mesh`` under a
fake world has the reference's shape and names and refuses other worlds;
``Collective.link_bytes`` equals the reference's.

Over 2 ranks on a ("data", "model") = (1, 2) mesh (one spawn for the
module, ``tests/_torch_ranks.py``; their group is the port's host-staged
backend, which the card needs for DTensor's collectives and which passes
host tensors to gloo, and its "data" dimension a group of one rank), at
the reduced qwen2 and qwen3-moe in
f32, against one process: the prefill logits within rtol 1e-5 (of the
largest logit), ``moe_block``'s expert-parallel f32 sum before its
rounding within rtol 1e-6, one LM round with b exact, losses within rtol
1e-5 and at most 0.1% of the coordinates apart, and a shard's wire equal
to the unsharded wire's bits coordinate for coordinate.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.distributed as jdist
from repro import configs as jc
from repro.launch import analysis as janalysis
from repro.launch import mesh as jmesh
from repro.models import build_specs as jbuild_specs
from repro.models import cache_logical as jcache_logical
from repro.models import input_logical as jinput_logical
from repro.models import input_specs as jinput_specs
from repro.models.spec import abstract_params as jabstract_params
from repro.models.spec import param_pspecs as jparam_pspecs
from repro_torch import configs as tc
from repro_torch import distributed, prng, tree
from repro_torch.core.quantizer import unpack_bits
from repro_torch.launch import analysis, fl_step, mesh as tmesh
from repro_torch.models import (
    abstract_params,
    build_specs,
    cache_logical,
    init_params,
    input_logical,
    input_specs,
    layers,
    moe,
    param_pspecs,
    prefill,
    sample_batch,
    train_loss,
)
from repro_torch.models import model as tmodel
from repro_torch.models.spec import is_spec

from _torch_ranks import run_ranks

ARCHS = tc.ARCH_IDS
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), ((2, 2), ("data", "model")),
          ((1, 2), ("data", "model"))]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32, "bool": torch.bool}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(t):
    return tree.leaves(t, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("fsdp", [None, "data"])
@pytest.mark.parametrize("shape,axes", MESHES, ids=lambda v: "x".join(map(str, v)) if isinstance(v[0], int) else None)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_reference(arch, shape, axes, fsdp):
    """Every leaf's entries, the FSDP pick of the largest divisible
    replicated dimension (ties to the higher index) included."""
    jfake = types.SimpleNamespace(axis_names=axes, axis_sizes=shape, empty=False)
    old = jdist.current_mesh
    jdist.current_mesh = lambda: jfake
    try:
        want = [tuple(p) for p in jax_leaves(jparam_pspecs(jbuild_specs(jc.get_config(arch)), fsdp_axis=fsdp))]
    finally:
        jdist.current_mesh = old
    with distributed.set_mesh(types.SimpleNamespace(mesh_dim_names=axes, shape=shape)):
        got = _leaves(param_pspecs(build_specs(tc.get_config(arch)), fsdp_axis=fsdp))
    assert got == want


def jax_leaves(t):
    import jax
    from jax.sharding import PartitionSpec

    return jax.tree_util.tree_leaves(t, is_leaf=lambda x: isinstance(x, PartitionSpec))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_inputs_and_cache_logical_equal_reference(arch):
    """Meta tensors of every leaf with the reference's shapes and dtypes;
    every kind's input specs and logical axes; the caches' logical axes."""
    import jax

    jcfg, tcfg = jc.get_config(arch), tc.get_config(arch)
    want = jax.tree_util.tree_leaves(jabstract_params(jbuild_specs(jcfg)))
    got = tree.leaves(abstract_params(build_specs(tcfg)))
    assert [(tuple(a.shape), DTYPES[str(a.dtype)]) for a in want] == [(tuple(t.shape), t.dtype) for t in got]
    assert all(t.device.type == "meta" for t in got)
    kinds = ("train", "prefill") if jcfg.encoder_only else ("train", "prefill", "decode")
    for kind in kinds:
        seq = 64 if jcfg.frontend != "vision" else jcfg.frontend_tokens + 32
        ws, ts = jinput_specs(jcfg, 4, seq, kind), input_specs(tcfg, 4, seq, kind)
        assert sorted(ws) == sorted(ts)
        for k in ws:
            assert tuple(ws[k].shape) == tuple(ts[k].shape) and DTYPES[str(ws[k].dtype)] == ts[k].dtype, (kind, k)
            assert ts[k].device.type == "meta"
        assert jinput_logical(jcfg, 4, seq, kind) == input_logical(tcfg, 4, seq, kind)
    assert jcache_logical(jcfg) == cache_logical(tcfg)


def _f32(specs):
    return tree.tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32), specs, is_leaf=is_spec)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-1.5-large-398b", "xlstm-350m"])
def test_remat_levers_keep_gradients(arch):
    """``train_loss``'s gradients at the reduced config in f32: the default
    unit checkpoint ("full"), "dots", ``inner_remat`` and no remat at all
    give the same bits."""
    cfg = tc.reduced(tc.get_config(arch))
    params = init_params(_f32(build_specs(cfg)), prng.key(0))
    batch = sample_batch(cfg, 2, 64, "train", seed=3)

    def grads():
        req = [w.detach().requires_grad_(True) for w in tree.leaves(params)]
        loss = train_loss(tree.unflatten(params, req), batch, cfg)
        return [g for g in torch.autograd.grad(loss, req, allow_unused=True) if g is not None]

    full = grads()
    with tmodel.remat_policy("dots"):
        dots = grads()
    with tmodel.inner_remat():
        inner = grads()
    with tmodel.indexed_params():
        indexed = grads()
    with tmodel.unit_remat(False):
        none = grads()
    for other in (dots, inner, indexed, none):
        assert len(other) == len(full) and all(torch.equal(a, b) for a, b in zip(full, other))
    with pytest.raises(ValueError, match="remat policy"):
        with tmodel.remat_policy("some"):
            pass


def test_production_mesh_under_fake_worlds():
    """The reference's shapes and names (its ``make_production_mesh``
    asked with ``make_mesh`` stubbed); any other world is refused with
    the size it needs; the fake group is gone after the block."""
    import torch.distributed as dist

    asked = []
    old = jmesh.make_mesh
    jmesh.make_mesh = lambda shape, axes: asked.append((tuple(shape), tuple(axes)))
    try:
        jmesh.make_production_mesh(multi_pod=False)
        jmesh.make_production_mesh(multi_pod=True)
    finally:
        jmesh.make_mesh = old
    for multi_pod, world in ((False, 256), (True, 512)):
        with tmesh.fake_world(world):
            m = tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            assert (tuple(m.shape), tuple(m.mesh_dim_names)) == asked[multi_pod]
        assert not dist.is_initialized()
    with tmesh.fake_world(8):
        for multi_pod, need in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"world of {need} ranks"):
                tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        with pytest.raises(RuntimeError, match="already started"):
            with tmesh.fake_world(2):
                pass
    with pytest.raises(ValueError, match="not been started"):
        tmesh.make_production_mesh()


@pytest.mark.parametrize("n", [2, 16, 256])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"])
def test_link_bytes_equal_reference(kind, n):
    for size in (1.0, 4096.0, 3.0e9):
        want = janalysis.Collective(kind, size, n).link_bytes
        assert analysis.Collective(kind, size, n).link_bytes == want


# -- two gloo ranks on a (1, 2) mesh ------------------------------------------

RANK_ARCHS = ("qwen2-1.5b", "qwen3-moe-30b-a3b")
STEP = dict(clients_per_round=4, local_steps=2, lr=0.01)


def _case(arch):
    cfg = tc.reduced(tc.get_config(arch))
    specs = _f32(build_specs(cfg))
    params = init_params(specs, prng.key(0))
    ls = tree.leaves(params)
    wire_leaf = max(range(len(ls)), key=lambda i: ls[i].numel())
    gen = torch.Generator().manual_seed(0)
    sb = sample_batch(cfg, 16, 32, "train", seed=2)
    return dict(cfg=cfg, specs=specs, batch=sample_batch(cfg, 2, 32, "prefill", seed=1),
                step_batch={k: v.view((2, 2, 2, 2) + v.shape[1:]) for k, v in sb.items()}, b=0.01,
                key=prng.key(5), fl=STEP, wire_leaf=wire_leaf,
                wire_delta=torch.randn(ls[wire_leaf].shape, generator=gen) * 0.01), params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's model-axis results for both configs (one spawn)."""
    jobs = {arch: ("model_axis", _case(arch)[0]) for arch in RANK_ARCHS}
    return run_ranks(2, tmp_path_factory.mktemp("model_axis"), "several", timeout=600,
                     backend=distributed.STAGED_BACKEND, **jobs)


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_model_axis_prefill_and_moe_equal_one_process(ranks, arch):
    kw, params = _case(arch)
    cfg = kw["cfg"]
    with torch.no_grad():
        want = prefill(params, kw["batch"], cfg)
        if cfg.n_experts:
            x2d = layers.embed_tokens(params["embed"], kw["batch"]["tokens"]).reshape(-1, cfg.d_model)
            p = {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}
            gates, idx = moe._route(x2d, p["router"], cfg.top_k)
            moe_sum = moe._expert_sum(x2d, gates, idx, p["w1"], p["w3"], p["w2"], moe.capacity(x2d.shape[0], cfg),
                                      cfg.n_experts)
    scale = float(want.abs().max())
    for r in ranks:
        got = r[arch]
        assert any("Shard" in p for p in got["placements"])
        torch.testing.assert_close(got["logits"], want, rtol=1e-5, atol=1e-5 * scale)
        if cfg.n_experts:
            torch.testing.assert_close(got["moe_sum"], moe_sum, rtol=1e-6, atol=1e-6 * float(moe_sum.abs().max()))


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_model_axis_step_equals_one_process(ranks, arch):
    """b exact, losses within rtol 1e-5, at most 0.1% of the coordinates
    apart; the step launches no kernel on the CPU."""
    kw, params = _case(arch)
    step = fl_step.make_fl_train_step(kw["cfg"], fl_step.DistFLConfig(**kw["fl"]))
    new, b, met = step(params, torch.tensor(kw["b"]), kw["step_batch"], kw["key"])
    n = sum(w.numel() for w in tree.leaves(new))
    for r in ranks:
        got = r[arch]
        assert got["b"] == float(b)
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(got["metrics"][k], float(met[k]), rtol=1e-5)
        assert got["metrics"]["wire_bytes"] == met["wire_bytes"]
        apart = sum(int((a != c).sum()) for a, c in zip(got["params_new"], tree.leaves(new)))
        assert apart <= 1e-3 * n
        assert not any(got["launches"].values())


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_model_axis_shard_wire_equals_unsharded_bits(ranks, arch):
    """Each rank's packed row of its shard of the largest leaf, unpacked,
    equals the unsharded wire's bits at the same coordinates."""
    kw, _ = _case(arch)
    delta = kw["wire_delta"]
    comp = fl_step.make_fl_train_step(kw["cfg"], fl_step.DistFLConfig(**kw["fl"])).pipeline.compressor
    wire, _ = comp.compress(prng.key(7), delta.reshape(1, -1), torch.tensor(kw["b"]), torch.zeros(()), row_offset=3)
    bits = (unpack_bits(wire.packed[0], delta.numel()) > 0).view(delta.shape)
    offsets = set()
    for r in ranks:
        got = r[arch]
        local, off = got["wire_bits"], got["wire_offset"]
        offsets.add(off)
        assert torch.equal(local, bits[tuple(slice(o, o + s) for o, s in zip(off, local.shape))])
    assert len(offsets) == 2  # the leaf is sharded: the ranks hold different coordinates
