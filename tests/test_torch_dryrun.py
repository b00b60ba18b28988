"""The port's dry run (``repro_torch.launch.dryrun``) and its counting on
the CPU.

The counterpart of the reference's ``test_dryrun_subprocess_8_devices``: a
step traced on a fake world of 8 ranks laid out (2, 2, 2) as ("pod",
"data", "model"), with fake tensors and the reduced configs, nothing
allocated. The train step of one architecture of each family (dense, MoE,
xLSTM, Mamba hybrid, audio, vision) reports ``status: ok``, collectives
over each mesh dimension, its FLOPs a device as the trace's global count
over the 8 ranks, and its peak; the reduced qwen2's prefill and decode
report ``status: ok``. A train step's global dot FLOPs on the mesh equal
those of the same step on plain tensors (the families without an MoE). Each run starts the fake group and destroys it on
its way out. Then the counter: ``prefill``'s ``dot_flops`` at each family's
reduced config, on plain tensors, equals the reference's ``count_fn`` with
its elementwise set emptied (dots only) exactly; the port's chunkwise mLSTM
does fewer products by design (a product of three operands whose first
pair shares every index is an elementwise multiply in torch's einsum, a
dot in JAX's), and the difference is given as a formula.
"""

import pytest
import torch

from repro import configs as jc
from repro.launch import flopcount as jflopcount
from repro.models import build_specs as jbuild_specs
from repro.models import prefill as jprefill
from repro.models import sample_batch as jsample_batch
from repro.models.spec import abstract_params as jabstract_params
from repro_torch import configs as tc
from repro_torch import prng
from repro_torch.launch import dryrun
from repro_torch.launch.flopcount import count_fn
from repro_torch.models import build_specs, init_params, prefill, sample_batch
from repro_torch.models.config import ShapeConfig

FAMILIES = {
    "dense": "qwen2-1.5b",
    "moe": "qwen3-moe-30b-a3b",
    "xlstm": "xlstm-350m",
    "mamba": "jamba-1.5-large-398b",
    "audio": "hubert-xlarge",
    "vision": "pixtral-12b",
}
MESH = (2, 2, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ok(rep: dict) -> dict:
    assert rep["status"] == "ok", rep.get("traceback")
    return rep


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dryrun_train_of_each_family(family):
    """Two clients (one a pod) of 2 sequences of 32 tokens; the traced case
    is the whole one (no extrapolation). Its global dot FLOPs (rank 0
    traces its pod; the count is times the pods) equal those of the same
    step on plain tensors in one process, the local regions' backward
    included; an MoE's expert slots on a mesh follow the reference's
    ``cap_local`` rule, so an MoE family's count differs by design."""
    import torch.distributed as dist
    from repro_torch.launch import fl_step

    arch = FAMILIES[family]
    rep = _ok(dryrun.run_case(arch, ShapeConfig("train_32", 32, 4, "train"), True, fl_clients=2,
                              device="cpu", mesh_shape=MESH, reduced=True))
    assert not dist.is_initialized()
    assert rep["engine"] == "ref" and rep["mesh"] == "2x2x2" and not rep["extrapolated"]
    assert all(rep["collective_calls_by_dim"].get(d, 0) > 0 for d in ("pod", "data", "model"))
    assert rep["flops_per_device"] == rep["global_flops"] / 8 and rep["dot_flops_per_device"] > 0
    assert rep["peak_bytes_per_device"] >= rep["arg_bytes_per_device"] > 0
    assert rep["bottleneck"] in ("compute", "memory", "collective")
    cfg = tc.reduced(tc.get_config(arch))
    if not cfg.n_experts:
        params = init_params(build_specs(cfg), prng.key(0))
        batch = {k: v.view((2, 1, 1, 2) + v.shape[1:]) for k, v in sample_batch(cfg, 4, 32, "train", seed=2).items()}
        # the dry run's step checkpoints each pattern unit, as the reference's lowers
        step = fl_step.make_fl_train_step(cfg, fl_step.DistFLConfig(clients_per_round=2, remat=True), engine="ref")
        assert rep["dot_flops_per_device"] * 8 == count_fn(step, params, torch.tensor(0.01), batch,
                                                           prng.key(1))["dot_flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dryrun_serving_kinds(kind):
    rep = _ok(dryrun.run_case("qwen2-1.5b", ShapeConfig(f"{kind}_32", 32, 4, kind), True, device="cpu",
                              mesh_shape=MESH, reduced=True))
    assert rep["n_collectives"] > 0 and rep["global_flops"] > 0


@pytest.mark.parametrize("kind,variant", [
    ("train", dict(rand_bits=16, fl_agg="fedavg_fp32", tag="rand16_fedavg")),
    ("train", dict(pure_dp=True, layer_remat=True, remat="dots", indexed=True, tag="pure_dp_remat")),
    ("decode", dict(serve_2d=True, tag="serve_2d")),
], ids=lambda v: v if isinstance(v, str) else v["tag"])
def test_dryrun_variants(kind, variant):
    """The reference's variants trace too (the reduced qwen2)."""
    rep = _ok(dryrun.run_case("qwen2-1.5b", ShapeConfig(f"{kind}_32", 32, 4, kind), True, fl_clients=2,
                              device="cpu", mesh_shape=MESH, reduced=True, **variant))
    assert rep["variant"] == variant["tag"] and rep["global_flops"] > 0
    assert rep.get("same_as") == ("this case without indexed_params" if variant.get("indexed") else None)


def test_dryrun_cli_skips_and_refuses():
    """The reference's skips; without a card and without ``--device cpu``
    it raises."""
    rep = dryrun.run_case("hubert-xlarge", "decode_32k", False, device="cpu")
    assert rep["status"] == "skipped"
    assert dryrun.cache_plan(tc.get_config("qwen2-1.5b"), dryrun.SHAPES["long_500k"]) == (8192, 8192)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            dryrun.run_case("qwen2-1.5b", "train_4k", False)


def _mlstm_dot_difference(cfg, batch: int, seq: int) -> float:
    """The reference's extra dot FLOPs in the mLSTM's two three-operand
    products a chunk: ``2 B c H hd`` and ``2 B c c H``."""
    dup = int(cfg.proj_factor * cfg.d_model)
    hd, c = dup // cfg.n_heads, min(256, seq)
    n_mlstm = sum(cfg.mixer_at(p) == "mlstm" for p in range(cfg.unit)) * cfg.reps
    return n_mlstm * (seq // c) * 2 * batch * c * cfg.n_heads * (hd + c)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_dot_flops_equal_reference(family, monkeypatch):
    arch, b, s = FAMILIES[family], 2, 64
    monkeypatch.setattr(jflopcount, "_ELEMENTWISE", set())
    jcfg = jc.reduced(jc.get_config(arch))
    want = jflopcount.count_fn(lambda p, bt: jprefill(p, bt, jcfg), jabstract_params(jbuild_specs(jcfg)),
                               jsample_batch(jcfg, b, s, "prefill"))["flops_total"]
    cfg = tc.reduced(tc.get_config(arch))
    params = init_params(build_specs(cfg), prng.key(0))
    batch = sample_batch(cfg, b, s, "prefill")
    with torch.no_grad():
        got = count_fn(lambda: prefill(params, batch, cfg))
    fewer = _mlstm_dot_difference(cfg, b, s) if "mlstm" in cfg.pattern else 0
    assert got["dot_flops"] == want - fewer
    assert got["unknown_while_loops"] == 0 and got["flops_total"] > got["dot_flops"] and got["bytes_total"] > 0
