"""Two repaired faults of the port, on the CPU.

The stacked leaves' backward: ``models.backbone`` takes each stacked leaf
apart once a call, so the LM step's backward writes each stacked gradient
once (one ``stack``), as the reference's ``lax.scan`` writes one stacked
buffer. A ``TorchDispatchMode`` over ``launch/fl_step.py:
_value_and_grad`` counts the elements that operations (views aside)
write in tensors of a stacked leaf's shape: at the reduced qwen2 cut to
2, 4 and 8 layers they stay at 1x the blocks' elements (a unit's index
wrote a zero leaf a unit and added them up: 3x, 7x, 15x). The gradients
equal those of the unit-indexing loop (each stacked gradient the units'
gradients side by side). A leaf that FSDP shards along its layer axis
keeps its placements in the backward too, with the one-process gradient
(3 gloo ranks).

The mesh: ``launch.mesh.make_mesh`` is on the card unless asked for the
CPU; without a card it raises, naming ``device_type="cpu"``.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs, prng, tree
from repro_torch.launch import fl_step
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_specs, init_params, sample_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StackedWrites(TorchDispatchMode):
    """Elements written by non-view operations into tensors of one of
    ``shapes``."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.elements = shapes, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and tuple(t.shape) in self.shapes:
                    self.elements += t.numel()
        return out


def _case(layers: int):
    cfg = dataclasses.replace(configs.reduced(configs.get_config("qwen2-1.5b")), n_layers=layers)
    params = init_params(build_specs(cfg), prng.key(0))
    return cfg, params, sample_batch(cfg, 2, 32, "train", seed=1)


@pytest.mark.parametrize("layers", [2, 4, 8])
def test_stacked_backward_writes_each_gradient_once(layers):
    cfg, params, batch = _case(layers)
    blocks = tree.leaves(params["blocks"])
    count = _StackedWrites({tuple(b.shape) for b in blocks})
    with count:
        _, grads = fl_step._value_and_grad(tree.leaves(params), params, batch, cfg)
    assert count.elements <= 1.05 * sum(b.numel() for b in blocks)
    assert all(torch.isfinite(g).all() for g in grads)


def test_stacked_gradients_equal_unit_indexing():
    """The gradients of the unbound loop equal those of a loop that indexes
    each unit (the parent's), bit for bit, up to the sign of a zero."""
    from repro_torch.models import model

    cfg, params, batch = _case(4)
    _, got = fl_step._value_and_grad(tree.leaves(params), params, batch, cfg)
    orig = model._unstack

    def indexed(t, reps):
        if isinstance(t, dict):
            return [{k: v for k, v in zip(t, vals)} for vals in zip(*(indexed(v, reps) for v in t.values()))]
        return [t[r] for r in range(reps)]

    try:
        model._unstack = indexed
        _, want = fl_step._value_and_grad(tree.leaves(params), params, batch, cfg)
    finally:
        model._unstack = orig
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_stacked_gradients_of_leaves_sharded_along_their_layers(tmp_path):
    """FSDP puts the data axis on a stacked leaf's layer axis where that is
    the only dimension the axis divides: the reduced xLSTM and Jamba cut to
    3 units on a ("data", "model") = (3, 1) mesh of 3 gloo ranks (Jamba's
    MoE with a slot for every token; two sequences a rank: at one, the
    reduced Jamba's gradients on this mesh are 0.3% off one process's in
    every leaf, with the unit-indexing loop too, an open fault). Each
    stacked leaf's gradient keeps the leaf's placements, those sharded
    along their layers among them, and equals the one-process gradient
    (f32, rtol 1e-5 of the leaf's largest)."""
    from repro_torch.models.spec import is_spec

    from _torch_ranks import run_ranks

    cases = {}
    for arch in ("xlstm-350m", "jamba-1.5-large-398b"):
        base = configs.reduced(configs.get_config(arch))
        # every expert a slot for every token, so the token shards drop none
        cfg = dataclasses.replace(base, n_layers=3 * base.unit,
                                  capacity_factor=base.n_experts / base.top_k if base.n_experts else base.capacity_factor)
        specs = tree.tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32), build_specs(cfg),
                              is_leaf=is_spec)
        cases[arch] = ("stacked_grads", dict(cfg=cfg, specs=specs, batch=sample_batch(cfg, 6, 16, "train", seed=1),
                                             mesh_shape=(3, 1)))
    ranks = run_ranks(3, tmp_path, "several", timeout=300, **cases)
    for arch, (_, kw) in cases.items():
        params = init_params(kw["specs"], prng.key(0))
        stacked = [w.requires_grad_(True) for w in tree.leaves(params["blocks"])]
        grad_tree = dict(params, blocks=tree.unflatten(params["blocks"], stacked))
        from repro_torch.models import train_loss

        want = torch.autograd.grad(train_loss(grad_tree, kw["batch"], kw["cfg"]), stacked)
        layered = 0
        for got in (r[arch] for r in ranks):
            for (param, grad), g, w in zip(got["placements"], got["grads"], want):
                assert grad == param
                layered += "Shard(dim=0)" in param
                assert torch.allclose(g, w, rtol=0, atol=1e-5 * float(w.abs().max())), arch
        assert layered, f"{arch}: no stacked leaf sharded along its layers"


def test_mesh_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tmesh.fake_world(2):
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            tmesh.make_mesh((2,), ("data",))
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            tmesh.make_campaign_mesh()
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            tmesh.make_host_mesh(2)
        assert tmesh.make_mesh((2,), ("data",), device_type="cpu").device_type == "cpu"
