"""Repaired faults of the port, on the CPU.

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

The reduced Jamba on a mesh at one sequence a rank (C2; 3 gloo ranks) and
on the one-card (1, 1) mesh at one sequence (C3) has the one-process
gradient.

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


def _stacked_case(arch: str, n_seq: int, moe: bool = True):
    """A reduced config cut to 3 units, its f32 specs and a batch of
    ``n_seq`` sequences of 16 tokens; an MoE gives every expert a slot for
    every token (so the token shards drop none), or is left out."""
    from repro_torch.models.spec import is_spec

    base = configs.reduced(configs.get_config(arch))
    kw = dict(n_layers=3 * base.unit)
    if base.n_experts:
        kw.update(capacity_factor=base.n_experts / base.top_k) if moe else kw.update(n_experts=0)
    cfg = dataclasses.replace(base, **kw)
    specs = tree.tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32), build_specs(cfg), is_leaf=is_spec)
    return cfg, specs, sample_batch(cfg, n_seq, 16, "train", seed=1)


def _one_process_grads(cfg, specs, batch):
    from repro_torch.models import train_loss

    params = init_params(specs, prng.key(0))
    stacked = [w.requires_grad_(True) for w in tree.leaves(params["blocks"])]
    grad_tree = dict(params, blocks=tree.unflatten(params["blocks"], stacked))
    return torch.autograd.grad(train_loss(grad_tree, batch, cfg), stacked)


def _hold_grads(got, want, what):
    """Each stacked gradient within 1e-5 of the leaf's largest (f32)."""
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=0, atol=1e-5 * float(w.abs().max())), what


# (arch, sequences, MoE) of each case on the (3, 1) mesh: two sequences a
# rank, then the reduced Jamba at one sequence a rank (ROADMAP C2)
STACKED = {"xlstm-350m": ("xlstm-350m", 6, True), "jamba-1.5-large-398b": ("jamba-1.5-large-398b", 6, True),
           "jamba-one-seq": ("jamba-1.5-large-398b", 3, True), "jamba-one-seq-no-moe": ("jamba-1.5-large-398b", 3, False)}


@pytest.fixture(scope="module")
def stacked_ranks(tmp_path_factory):
    """Every case's gradients on a ("data", "model") = (3, 1) mesh of 3 gloo
    ranks (one spawn), beside each case's inputs."""
    from _torch_ranks import run_ranks

    cases = {name: _stacked_case(*c) for name, c in STACKED.items()}
    jobs = {name: ("stacked_grads", dict(cfg=cfg, specs=specs, batch=batch, mesh_shape=(3, 1)))
            for name, (cfg, specs, batch) in cases.items()}
    return cases, run_ranks(3, tmp_path_factory.mktemp("stacked"), "several", timeout=300, **jobs)


def test_stacked_gradients_of_leaves_sharded_along_their_layers(stacked_ranks):
    """FSDP puts the data axis on a stacked leaf's layer axis where that is
    the only dimension the axis divides: the reduced xLSTM and Jamba cut to
    3 units on a ("data", "model") = (3, 1) mesh of 3 gloo ranks (Jamba's
    MoE with a slot for every token), two sequences a rank. Each stacked
    leaf's gradient keeps the leaf's placements, those sharded along their
    layers among them, and equals the one-process gradient (f32, rtol 1e-5
    of the leaf's largest)."""
    cases, ranks = stacked_ranks
    for arch in ("xlstm-350m", "jamba-1.5-large-398b"):
        want = _one_process_grads(*cases[arch])
        layered = 0
        for got in (r[arch] for r in ranks):
            for (param, grad), g in zip(got["placements"], got["grads"]):
                assert grad == param
                layered += "Shard(dim=0)" in param
            _hold_grads(got["grads"], want, arch)
        assert layered, f"{arch}: no stacked leaf sharded along its layers"


@pytest.mark.parametrize("name", ["jamba-one-seq", "jamba-one-seq-no-moe"])
def test_one_sequence_a_rank_jamba_gradients_equal_one_process(stacked_ranks, name):
    """C2: the reduced Jamba (with its MoE and without) at one sequence a
    rank on the (3, 1) mesh: every stacked gradient within 1e-5 of the
    leaf's largest of one process's. The Mamba scan's ``bcds,bcs->bcd``
    contraction was a ``torch.einsum``, which takes another path for a
    batch of one sequence and rounds otherwise; the attention after it
    amplified the last-bit differences to 0.06% of the gradients. It is a
    batched matmul now, whose rows do not depend on the batch."""
    cases, ranks = stacked_ranks
    want = _one_process_grads(*cases[name])
    for r in ranks:
        _hold_grads(r[name]["grads"], want, name)


def test_one_sequence_on_the_one_card_mesh(tmp_path):
    """C3: the reduced Jamba at one sequence on the trainer's one-card
    (1, 1) mesh (``make_host_mesh(1)``, CPU, one gloo rank in this
    process) runs forward and backward, and every stacked gradient is
    within 1e-5 of the leaf's largest of one process's. The backward used
    to raise: the causal convolution unsqueezed its per-channel weights
    against a batch that "data" shards, and at a global batch of 1 the
    backward's squeeze landed on the sharded size-1 dimension; the MoE's
    reshape of a sharded batch of one into tokens raised in the forward."""
    import torch.distributed as dist

    from repro_torch import distributed
    from repro_torch.models import train_loss

    cfg, specs, batch = _stacked_case("jamba-1.5-large-398b", 1)
    want = _one_process_grads(cfg, specs, batch)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = tmesh.make_host_mesh(1, device_type="cpu")
        params = init_params(specs, prng.key(0), mesh=mesh, fsdp_axis="data")
        stacked = [w.detach().requires_grad_(True) for w in tree.leaves(params["blocks"])]
        grad_tree = dict(params, blocks=tree.unflatten(params["blocks"], stacked))
        with distributed.set_mesh(mesh), distributed.mesh_context(grad_tree):
            grads = torch.autograd.grad(train_loss(grad_tree, batch, cfg), stacked)
        _hold_grads([g.full_tensor() for g in grads], want, "one-card mesh")
    finally:
        dist.destroy_process_group()


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
