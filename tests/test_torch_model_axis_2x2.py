"""The port's model axis over 4 gloo ranks on a ("data", "model") = (2, 2)
mesh on the CPU: FSDP over "data" (each weight gathered where a product
needs it, gradients summed over the data split), tensor and expert
parallelism over "model", and the MoE's token-sharded expert-parallel
branch (the tokens split over "data", ``cap_local`` slots an expert).

Against one process, in f32 (one spawn for the module,
``tests/_torch_ranks.py``, on the port's host-staged backend): at the
reduced qwen2, and at the reduced qwen3-moe with ``capacity_factor =
n_experts / top_k`` (every expert has a slot for every token, one process
and each token shard alike, so no token is dropped and the two compute
the same function), the prefill logits within rtol 1e-5 (of the largest
logit), one LM round (each pattern unit checkpointed on the ranks, not
in the one process) with b exact, losses within rtol 1e-5 and at most
0.1% of the coordinates apart, each stacked leaf's gradient after the
round laid out as the leaf, and a shard's wire equal to the unsharded
wire's bits coordinate for coordinate.

At the reduced qwen3-moe's own capacity factor, ``cap_local`` drops other
tokens than one process does, so ``moe_block``'s f32 sum on the mesh is
held to the reference's ``shard_map`` branch run on 4 host devices in a
subprocess, on the same weights and tokens, within rtol 1e-6 (and shown to
differ from the one-process block, so the rule is seen).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs as tc
from repro_torch import distributed, prng, tree
from repro_torch.core.quantizer import unpack_bits
from repro_torch.launch import fl_step
from repro_torch.models import build_specs, init_params, layers, moe, prefill, sample_batch
from repro_torch.models.spec import is_spec

from _torch_ranks import run_ranks

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
MESH = (2, 2)
RANK_ARCHS = ("qwen2-1.5b", "qwen3-moe-30b-a3b")
STEP = dict(clients_per_round=2, local_steps=2, lr=0.01, remat=True)  # one process: remat off


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(specs):
    return tree.tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32), specs, is_leaf=is_spec)


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k) if cfg.n_experts else cfg


def _case(arch):
    """The ranks' job arguments and the one-process parameters."""
    own = tc.reduced(tc.get_config(arch))
    cfg = _drop_free(own)
    specs = _f32(build_specs(cfg))
    params = init_params(specs, prng.key(0))
    ls = tree.leaves(params)
    wire_leaf = max(range(len(ls)), key=lambda i: ls[i].numel())
    gen = torch.Generator().manual_seed(0)
    sb = sample_batch(cfg, 8, 32, "train", seed=2)
    return dict(cfg=cfg, specs=specs, batch=sample_batch(cfg, 2, 32, "prefill", seed=1),
                step_batch={k: v.view((2, 1, 2, 2) + v.shape[1:]) for k, v in sb.items()}, b=0.01,
                key=prng.key(5), fl=STEP, wire_leaf=wire_leaf,
                wire_delta=torch.randn(ls[wire_leaf].shape, generator=gen) * 0.01, mesh_shape=MESH,
                moe_cfg=own, moe_tokens=torch.from_numpy(np.random.default_rng(4).integers(0, 6, (2, 32)))), params


def _moe_inputs(kw, params):
    """The first MoE block's weights and the embedded MoE tokens (T, d):
    64 tokens of 6 ids, so that some experts are routed more tokens than
    they have slots."""
    with torch.no_grad():
        x2d = layers.embed_tokens(params["embed"], kw["moe_tokens"]).reshape(-1, kw["cfg"].d_model)
    return {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}, x2d


_REFERENCE_MOE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.distributed import set_mesh
    from repro.launch.mesh import make_mesh
    from repro.models import moe

    d = np.load(sys.argv[1])
    cfg = configs.reduced(configs.get_config("qwen3-moe-30b-a3b"))
    mesh = make_mesh((2, 2), ("data", "model"))
    with set_mesh(mesh):
        p = {k: jnp.asarray(d[k]) for k in ("router", "w1", "w3", "w2")}
        out = jax.jit(lambda p, x: moe.moe_block(p, x, cfg))(p, jnp.asarray(d["x"])[None])
    np.save(sys.argv[2], np.asarray(out)[0])
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results for both configs (one spawn), and the
    reference's mesh ``moe_block`` (a JAX subprocess beside the ranks)."""
    tmp = tmp_path_factory.mktemp("model_axis_2x2")
    kw, params = _case("qwen3-moe-30b-a3b")
    p, x2d = _moe_inputs(kw, params)
    np.savez(tmp / "moe_in.npz", x=x2d.numpy(), **{k: v.numpy() for k, v in p.items()})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE_MOE, str(tmp / "moe_in.npz"), str(tmp / "moe_out.npy")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jobs = {arch: ("model_axis", _case(arch)[0]) for arch in RANK_ARCHS}
        ranks = run_ranks(4, tmp, "several", timeout=600, backend=distributed.STAGED_BACKEND, **jobs)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return ranks, torch.from_numpy(np.load(tmp / "moe_out.npy"))


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_mesh_2x2_prefill_equals_one_process(runs, arch):
    """Every weight is sharded over both mesh dimensions somewhere; the
    logits match one process."""
    kw, params = _case(arch)
    with torch.no_grad():
        want = prefill(params, kw["batch"], kw["cfg"])
    scale = float(want.abs().max())
    for got in (r[arch] for r in runs[0]):
        assert any("Shard" in p.split(",")[0] and "Shard" in p.split(",")[1] for p in got["placements"])
        torch.testing.assert_close(got["logits"], want, rtol=1e-5, atol=1e-5 * scale)


def test_mesh_2x2_token_sharded_moe_equals_reference_shard_map(runs):
    """The f32 sum of the token-sharded expert-parallel branch equals the
    reference's ``shard_map`` branch on 4 host devices; one process,
    whose capacity drops other tokens, gives another sum."""
    kw, params = _case("qwen3-moe-30b-a3b")
    ranks, want = runs
    p, x2d = _moe_inputs(kw, params)
    own = kw["moe_cfg"]
    with torch.no_grad():
        gates, idx = moe._route(x2d, p["router"], own.top_k)
        one = moe._expert_sum(x2d, gates, idx, p["w1"], p["w3"], p["w2"], moe.capacity(x2d.shape[0], own),
                              own.n_experts)
    scale = float(want.abs().max())
    assert not torch.allclose(one, want, rtol=1e-3, atol=1e-3 * scale)
    for got in (r["qwen3-moe-30b-a3b"] for r in ranks):
        assert "Shard(dim=0)" in got["moe_placements"]  # the tokens stayed split over "data"
        torch.testing.assert_close(got["moe_sum"], want, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_mesh_2x2_step_equals_one_process(runs, arch):
    """b exact, losses within rtol 1e-5, at most 0.1% of the coordinates
    apart; the step launches no kernel on the CPU."""
    kw, params = _case(arch)
    step = fl_step.make_fl_train_step(kw["cfg"], fl_step.DistFLConfig(**dict(kw["fl"], remat=False)))
    new, b, met = step(params, torch.tensor(kw["b"]), kw["step_batch"], kw["key"])
    n = sum(w.numel() for w in tree.leaves(new))
    for got in (r[arch] for r in runs[0]):
        assert got["b"] == float(b)
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(got["metrics"][k], float(met[k]), rtol=1e-5)
        assert got["metrics"]["wire_bytes"] == met["wire_bytes"]
        apart = sum(int((a != c).sum()) for a, c in zip(got["params_new"], tree.leaves(new)))
        assert apart <= 1e-3 * n
        assert not any(got["launches"].values())


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_mesh_2x2_stacked_gradients_keep_placements(runs, arch):
    """After one LM round, each stacked leaf's gradient comes out of the
    backward laid out as the leaf (none replicated or pending a sum), so no
    rank gathers a stacked gradient whole."""
    for got in (r[arch] for r in runs[0]):
        assert got["stacked_placements"]
        for param, grad in got["stacked_placements"]:
            assert grad == param


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_mesh_2x2_shard_wire_equals_unsharded_bits(runs, arch):
    """Each rank's packed row of its shard of the largest leaf (split over
    both mesh dimensions), unpacked, equals the unsharded wire's bits at
    the same coordinates."""
    kw, _ = _case(arch)
    delta = kw["wire_delta"]
    comp = fl_step.make_fl_train_step(kw["cfg"], fl_step.DistFLConfig(**kw["fl"])).pipeline.compressor
    wire, _ = comp.compress(prng.key(7), delta.reshape(1, -1), torch.tensor(kw["b"]), torch.zeros(()), row_offset=3)
    bits = (unpack_bits(wire.packed[0], delta.numel()) > 0).view(delta.shape)
    offsets = set()
    for got in (r[arch] for r in runs[0]):
        local, off = got["wire_bits"], got["wire_offset"]
        offsets.add(off)
        assert torch.equal(local, bits[tuple(slice(o, o + s) for o, s in zip(off, local.shape))])
    assert len(offsets) == 4  # four ranks, four blocks of coordinates
