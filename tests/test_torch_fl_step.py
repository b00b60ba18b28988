"""The port's federated LM round (repro_torch.launch.fl_step) and trainer
against the reference's (repro.launch.fl_step, repro.launch.train), on the
CPU: the 16-bit threshold, exact counts at M = 300 with a fake loss at 32
and 16 bits, the b controller, the local step's bf16 arithmetic as XLA
compiles it, real-loss rounds on a micro qwen2, the CLI and checkpoints
both ways. Mirrors tests/test_fl_step.py."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.core.bcontrol import BControlConfig as JBC
from repro.core.bcontrol import BState as JBState
from repro.core.bcontrol import update_b as j_update_b
from repro.core.quantizer import threshold_u16 as j_threshold
from repro.distributed import set_mesh
from repro.launch import fl_step as jfs
from repro.launch.mesh import make_host_mesh
from repro.models import build_specs as jbs
from repro.models.spec import init_params as jip
from repro.models.spec import param_pspecs
from repro_torch import configs as tc
from repro_torch import prng, tree
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.core import ClientCompressor, build_pipeline
from repro_torch.core.bcontrol import BState, update_b
from repro_torch.core.quantizer import threshold_u16, unpack_bits
from repro_torch.data import make_lm_streams
from repro_torch.fl.pytree_wire import pytree_wire_bytes
from repro_torch.kernels import ops
from repro_torch.launch import fl_step as tfs
from repro_torch.launch import train
from repro_torch.models import build_specs as tbs
from repro_torch.models import init_params as tip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def micro(configs, n_layers=1):
    return dataclasses.replace(configs.get_config("qwen2-1.5b"), name="qwen2-micro", n_layers=n_layers, d_model=32,
                               n_heads=2, n_kv_heads=1, d_ff=64, vocab=64, d_head=16)


def to_torch(jp, dtype=torch.bfloat16):
    """The reference's tree as the port's, every leaf of ``dtype``, or each
    in its own dtype (f32 or bf16) when ``dtype`` is None."""
    def one(a):
        t = dtype or (torch.float32 if a.dtype == jnp.float32 else torch.bfloat16)
        return torch.from_numpy(np.array(a, np.float32)).to(t)
    return tree.tree_map(one, jp)


def test_threshold_u16_keeps_saturated_votes_certain():
    p = np.array([0.0, 0.25, 0.5, 0.999, 1.0], np.float32)
    got = threshold_u16(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_threshold(jnp.asarray(p))).astype(np.int64))
    assert int(got[-1]) == 65536 and bool((torch.tensor(65535) < got[-1]))


@pytest.mark.parametrize("rand_bits", [32, 16])
def test_saturated_deltas_transmit_certain_votes(rand_bits):
    d = 12
    comp = ClientCompressor(rand_bits=rand_bits)
    for sign in (1.0, -1.0):
        wire, _ = comp.compress(prng.key(0), torch.full((3, d), sign * 0.25), torch.tensor(0.25), torch.zeros(3, d))
        codes = torch.stack([unpack_bits(p, d) for p in wire.packed])
        assert bool((codes == sign).all()), (rand_bits, sign)


def test_rand_bits_checks_are_the_references():
    assert build_pipeline("probit_plus", rand_bits=16).compressor.rand_bits == 16
    with pytest.raises(ValueError, match="rand_bits"):
        build_pipeline("probit_plus", rand_bits=8)
    with pytest.raises(ValueError, match="kernel"):
        ClientCompressor(rand_bits=16, use_kernels=True)
    with pytest.raises(ValueError, match="top-k"):
        ClientCompressor(rand_bits=16, topk_frac=0.5)
    with pytest.raises(ValueError, match="rand_bits=32"):
        ClientCompressor(rand_bits=16, wire_bits=2)
    with pytest.raises(ValueError, match="aggregator"):
        tfs.DistFLConfig(aggregator="fedavg")


def fake_loss(p, sb, c):
    """A loss whose gradient is exactly -100 a coordinate: one local step at
    lr = 0.01 moves every weight by +1.0."""
    if isinstance(p, dict) and torch.is_tensor(tree.leaves(p)[0]):
        return -100.0 * sum(leaf.float().sum() for leaf in tree.leaves(p))
    return -100.0 * sum(jnp.sum(leaf.astype(jnp.float32)) for leaf in jax.tree.leaves(p))


@pytest.mark.parametrize("rand_bits", [32, 16])
def test_fl_step_counts_exact_at_m300(monkeypatch, rand_bits):
    """M = 300 clients whose every delta saturates at +1.0 >> b: every vote
    is a certain +1, the counts are exactly 300, and the new parameters are
    exactly ``w + b`` in bf16 (a uint8 count would wrap to 44, a uint16
    threshold would send -1); b contracts on the tied vote, and the reported
    wire bytes are the pipeline's. The fake loss reads no model, so the
    tree is one leaf of 9 weights (9 % 8 != 0). Against the reference at
    its own test's bar, atol 1e-5: XLA fuses ``w + theta`` with the
    estimate's multiply, so where ``w = -b`` its new weight is ~1.2e-8,
    not 0."""
    m = 300
    monkeypatch.setattr(jfs, "train_loss", fake_loss)
    monkeypatch.setattr(tfs, "train_loss", fake_loss)
    w0 = np.random.default_rng(0).standard_normal((3, 3)).astype(np.float32)
    w0[0, 0] = -0.5
    jp = {"w": jnp.asarray(w0, jnp.bfloat16)}
    with set_mesh(make_host_mesh()):
        fl = jfs.DistFLConfig(clients_per_round=m, local_steps=1, lr=0.01, rand_bits=rand_bits)
        step = jax.jit(jfs.make_fl_train_step(micro(jc), fl, None))
        batch = {"x": jnp.zeros((m, 1, 1, 1, 2), jnp.float32)}
        j_new, j_b, _ = step(jp, jnp.float32(0.5), batch, jax.random.PRNGKey(1))
    tp = to_torch(jp)
    tstep = tfs.make_fl_train_step(micro(tc), tfs.DistFLConfig(clients_per_round=m, local_steps=1, lr=0.01,
                                                               rand_bits=rand_bits))
    t_new, t_b, met = tstep(tp, torch.tensor(0.5), {"x": torch.zeros((m, 1, 1, 1, 2))}, prng.key(1))
    for a, c, w in zip(jax.tree.leaves(j_new), tree.leaves(t_new), tree.leaves(tp)):
        np.testing.assert_allclose(c.float().numpy(), np.asarray(a, np.float32), rtol=0, atol=1e-5)
        assert torch.equal(c, (w.float() + 0.5).to(torch.bfloat16))
    assert float(t_b) == float(j_b) == float(np.float32(0.5) * np.float32(0.98))
    assert met["wire_bytes"] == pytree_wire_bytes(tstep.pipeline, tp, m)["wire_bytes"] > 0
    assert tstep.pipeline.compressor.use_kernels == (rand_bits == 32)


def test_update_b_parity_with_simulation():
    fl = tfs.DistFLConfig(b_up=1.05, b_down=0.9)
    jfl = jfs.DistFLConfig(b_up=1.05, b_down=0.9)
    b0 = torch.tensor(0.02)
    for vote in (-4.0, 0.0, 7.0):
        got = tfs.update_b_dist(b0, torch.tensor(vote), fl)
        want = jfs.update_b_dist(jnp.float32(0.02), jnp.float32(vote), jfl)
        assert float(got) == float(want), vote
    bits = torch.tensor([1, -1, -1, 1, 1], dtype=torch.int8)
    stream = update_b(BState(b=b0, prev_vote=torch.tensor(0.0)), bits, tfs.bcontrol_config(fl)).b
    j_stream = j_update_b(JBState(b=jnp.float32(0.02), prev_vote=jnp.float32(0.0)),
                          jnp.asarray(bits.numpy()), JBC(mode="dynamic", up=1.05, down=0.9)).b
    assert float(tfs.update_b_dist(b0, bits.float().sum(), fl)) == float(stream) == float(j_stream)


def test_local_step_is_the_jitted_references():
    """Stage test of the bf16 local step and model difference: on bf16
    weights, gradients and global weights, the port's update equals the
    jitted reference's over two steps bit for bit (XLA keeps ``w - w0`` in
    f32 and fuses both multiply-adds; rounding ``w - w0`` to bf16 first
    differs), and so does the f32 model difference of a bf16 pair (XLA drops
    the bf16 rounding of ``a - c``, which differs in ~5% of coordinates)."""
    rng = np.random.default_rng(0)
    n = 200_000
    w0, g1, g2 = (jnp.asarray(rng.standard_normal(n) * s, jnp.bfloat16) for s in (0.1, 0.5, 0.5))
    fl = tfs.DistFLConfig()
    upd = jax.jit(lambda w, gg, w0: (w - fl.lr * (gg.astype(jnp.float32)
                                                  + fl.lam * (w - w0).astype(jnp.float32))).astype(w.dtype))
    w1 = upd(w0, g1, w0)
    w2 = upd(w1, g2, w0)
    t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) for k, v in
         dict(w0=w0, g1=g1, g2=g2).items()}
    t1 = tfs._local_step([t["w0"]], [t["g1"]], [t["w0"]], fl)[0]
    t2 = tfs._local_step([t1], [t["g2"]], [t["w0"]], fl)[0]
    np.testing.assert_array_equal(t1.float().numpy(), np.asarray(w1, np.float32))
    np.testing.assert_array_equal(t2.float().numpy(), np.asarray(w2, np.float32))
    delta = np.asarray(jax.jit(lambda a, c: (a - c).astype(jnp.float32))(w2, w0))
    np.testing.assert_array_equal((t2.float() - t["w0"].float()).numpy(), delta)
    assert ((t2 - t["w0"]).float().numpy() != delta).mean() > 0.01


M, L, PB, S = 4, 2, 2, 16


def run_rounds(jcfg, tcfg, aggregator, rand_bits, dtype, rounds=2):
    """``rounds`` rounds of both steps from the same state on the same
    batches; each round starts both from the reference's state. Yields each
    round's (reference, port) results. ``dtype`` None keeps each leaf's
    spec dtype (bf16, the MoE router f32)."""
    streams = make_lm_streams(0, M, jcfg.vocab, S + 1, L * PB * rounds)
    jt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, None: None}[dtype]
    with set_mesh(make_host_mesh()):
        specs = jbs(jcfg)
        jp = jax.tree.map(lambda a: a.astype(jt or a.dtype), jip(specs, jax.random.PRNGKey(0)))
        jfl = jfs.DistFLConfig(clients_per_round=M, local_steps=L, aggregator=aggregator, rand_bits=rand_bits)
        jstep = jax.jit(jfs.make_fl_train_step(jcfg, jfl, param_pspecs(specs)))
        tstep = tfs.make_fl_train_step(tcfg, tfs.DistFLConfig(clients_per_round=M, local_steps=L,
                                                              aggregator=aggregator, rand_bits=rand_bits))
        jb, jk, tk = jnp.float32(0.01), jax.random.PRNGKey(1), prng.key(1)
        for r in range(rounds):
            toks = np.stack([s[r * L * PB:(r + 1) * L * PB].reshape(L, PB, S + 1) for s in streams])[:, None]
            jk, jkr = jax.random.split(jk)
            tk, tkr = prng.split(tk, 2)
            tp, tb = to_torch(jp, dtype), torch.tensor(float(jb))
            batch = frontend_batch(jcfg, toks, np.random.default_rng(r))
            # frames and patches in the parameters' dtype (bf16 under own dtypes)
            t_out = tstep(tp, tb, {k: torch.from_numpy(v).to(dtype or torch.bfloat16) if v.dtype == np.float32
                                   else torch.from_numpy(v) for k, v in batch.items()}, tkr)
            jp, jb, jm = jstep(jp, jb, {k: jnp.asarray(v, jt or jnp.bfloat16) if v.dtype == np.float32
                                        else jnp.asarray(v) for k, v in batch.items()}, jkr)
            yield (jp, jb, jm), t_out


def frontend_batch(cfg, toks, rng):
    """A round's numpy batch: tokens ``s[:-1]`` and labels ``s[1:]``; a
    vision model's f32 patches (normals) before them; an audio model's f32
    frames (normals), ~30% of them masked, labelled ``s[:-1] % vocab``."""
    lead = toks.shape[:4]
    if cfg.frontend == "vision":
        patches = rng.standard_normal(lead + (cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        return {"patches": patches, "tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.frontend == "audio":
        feats = rng.standard_normal(lead + (S, cfg.d_model)).astype(np.float32)
        return {"feats": feats, "labels": toks[..., :-1] % cfg.vocab, "mask": rng.random(lead + (S,)) < 0.3}
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@pytest.mark.parametrize("rand_bits", [32, 16])
def test_real_loss_rounds_exact_at_f32_parameters(rand_bits):
    """A micro qwen2 with f32 parameters, two rounds of PRoBit+: the new
    parameters and b equal the jitted reference's bit for bit, the losses
    within rtol 1e-6 (the model's reductions run in another order)."""
    for (jp, jb, jm), (tp, tb, tm) in run_rounds(micro(jc, 2), micro(tc, 2), "probit_plus", rand_bits, torch.float32):
        for a, c in zip(jax.tree.leaves(jp), tree.leaves(tp)):
            np.testing.assert_array_equal(c.numpy(), np.asarray(a))
        assert float(tb) == float(jb)
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


def test_real_loss_rounds_bf16():
    """The same in bf16, the trainer's dtype: XLA and torch round the bf16
    model's intermediates differently (test_torch_lm_model.py), so the
    gradients differ in the last bits, and a local model's bf16 rounding
    with them. Measured on this CPU: losses within 2.2e-4 relative and
    0.10-0.17% of the parameters one bf16 step apart; bars: losses rtol
    1e-3, b exact, at most 0.5% of the parameters differing, each by at
    most 2 ** -7 relative or 2b."""
    for (jp, jb, jm), (tp, tb, tm) in run_rounds(micro(jc, 2), micro(tc, 2), "probit_plus", 32, torch.bfloat16):
        got = np.concatenate([c.float().numpy().ravel() for c in tree.leaves(tp)])
        want = np.concatenate([np.asarray(a, np.float32).ravel() for a in jax.tree.leaves(jp)])
        diff = got != want
        assert diff.mean() <= 0.005
        assert np.all(np.abs(got - want)[diff] <= np.maximum(2.0**-7 * np.abs(want[diff]), 2.0 * float(jb)))
        assert float(tb) == float(jb)
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3)


def test_fedavg_round_at_f32_parameters():
    """The full-precision baseline: the mean of the f32 model differences,
    within float rounding of the reference's (the model's gradients differ
    in the last bits)."""
    for (jp, jb, jm), (tp, tb, tm) in run_rounds(micro(jc, 2), micro(tc, 2), "fedavg_fp32", 32, torch.float32):
        for a, c in zip(jax.tree.leaves(jp), tree.leaves(tp)):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
        assert float(tb) == float(jb)
        assert tm["wire_bytes"] == M * 4 * sum(c.numel() for c in tree.leaves(tp))


def test_train_main_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "run.json"
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--rounds", "2", "--clients", "2", "--seq", "32",
            "--per-batch", "1", "--local-steps", "1", "--smoke", "--json-out", str(out), "--ckpt-dir", str(tmp_path)]
    assert train.main(argv) == 0
    assert "SMOKE OK" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert len(rep["rounds"]) == 2 and all(np.isfinite(r["loss_last"]) for r in rep["rounds"])
    assert rep["wire"]["wire_bytes_f32"] / rep["wire"]["wire_bytes_ideal"] == pytest.approx(32, rel=1e-3)
    assert latest_step(str(tmp_path)) == 2
    one_round = argv[:-4] + ["--rounds", "1", "--clients", "1"]
    assert train.main(one_round + ["--rand-bits", "16", "--aggregator", "probit_plus"]) == 0
    assert train.main(one_round + ["--aggregator", "fedavg_fp32"]) == 0
    with pytest.raises(ValueError, match="world of 256 ranks"):
        train.main(argv + ["--production-mesh"])
    # the Mamba hybrid and the two frontends train: test_train_main_runs_new_families_on_cpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "qwen2-1.5b", "--reduced"])


def micro_family(configs, arch):
    """A narrow two-layer member of the MoE, xLSTM, Mamba-hybrid, audio or
    vision family (its reduced config at d_model 32; jamba's Mamba d_in 64,
    dt_rank 2; pixtral's 16 patches)."""
    small = dict(name=arch + "-micro", d_model=32, n_heads=2, n_kv_heads=1, d_head=16, vocab=64)
    if arch in ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b"):
        small.update(moe_d_ff=32)
    if arch in ("jamba-1.5-large-398b", "hubert-xlarge", "pixtral-12b"):
        small.update(d_ff=64)
    return dataclasses.replace(configs.reduced(configs.get_config(arch)), **small)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-350m"])
def test_new_family_rounds_exact_at_f32_parameters(arch):
    """Two PRoBit+ rounds of a micro MoE (4 experts, top-2, capacity drops
    at 2 x 16 tokens: 8 slots an expert for ~16 routed) and a micro xLSTM
    (an mLSTM and an sLSTM block) with f32 parameters: the new parameters
    and b equal the jitted reference's bit for bit, the losses within rtol
    1e-6, the wire bytes one kernel-wire row a leaf."""
    for (jp, jb, jm), (tp, tb, tm) in run_rounds(micro_family(jc, arch), micro_family(tc, arch), "probit_plus", 32,
                                                 torch.float32):
        for a, c in zip(jax.tree.leaves(jp), tree.leaves(tp)):
            np.testing.assert_array_equal(c.numpy(), np.asarray(a))
        assert float(tb) == float(jb)
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        # one kernel-wire row a leaf: padded to whole 1024-coordinate rows
        # (the reference's chunked packer pads its small leaves further)
        assert tm["wire_bytes"] == M * sum(ops.padded_len(c.numel()) // 8 for c in tree.leaves(tp))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-350m"])
def test_new_family_rounds_in_their_own_dtypes(arch):
    """The same in the trainer's dtypes (bf16, the MoE router f32): the
    router stays f32 through the local step, the wire and the new
    parameters; the bars of test_real_loss_rounds_bf16 (losses rtol 1e-3, b
    exact, at most 0.5% of the parameters differing, each by at most 2 **
    -7 relative or 2b)."""
    for (jp, jb, jm), (tp, tb, tm) in run_rounds(micro_family(jc, arch), micro_family(tc, arch), "probit_plus", 32,
                                                 None):
        for a, c in zip(jax.tree.leaves(jp), tree.leaves(tp)):
            assert c.dtype == (torch.float32 if a.dtype == jnp.float32 else torch.bfloat16)
        got = np.concatenate([c.float().numpy().ravel() for c in tree.leaves(tp)])
        want = np.concatenate([np.asarray(a, np.float32).ravel() for a in jax.tree.leaves(jp)])
        diff = got != want
        assert diff.mean() <= 0.005
        assert np.all(np.abs(got - want)[diff] <= np.maximum(2.0**-7 * np.abs(want[diff]), 2.0 * float(jb)))
        assert float(tb) == float(jb)
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3)
    if arch == "qwen3-moe-30b-a3b":
        assert sum(a.dtype == jnp.float32 for a in jax.tree.leaves(jp)) == 1


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "hubert-xlarge", "pixtral-12b"])
def test_hybrid_and_frontend_rounds_at_f32_parameters(arch):
    """Two PRoBit+ rounds of a micro jamba (a Mamba position over one chunk,
    an attention position with the MoE FFN), a micro hubert (the audio
    frontend, ~30% of its frames masked, the encoder-only head) and a micro
    pixtral (16 patches before 16 tokens) with f32 parameters and frames or
    patches, the wire bytes one kernel-wire row a leaf. jamba and pixtral:
    the new parameters and b equal the jitted reference's bit for bit (the
    Mamba scan's multiply-adds are fused as XLA fuses them), the losses
    within rtol 1e-6. hubert's gradients differ from the reference's in the
    last bits (torch's f32 tanh-GELU, the summation orders), and a
    coordinate whose delta lies that close to its quantizer's threshold
    flips a client's vote: measured one of its 18,784 coordinates in round
    2, one vote (2b/M) apart, and its round-2 loss after the local step
    2.4e-6 relative; so hubert is held to test_real_loss_rounds_bf16's bars
    (losses rtol 1e-3, b exact, at most 0.5% of the parameters differing,
    each by at most 2 ** -7 relative or 2b)."""
    exact = arch != "hubert-xlarge"
    for (jp, jb, jm), (tp, tb, tm) in run_rounds(micro_family(jc, arch), micro_family(tc, arch), "probit_plus", 32,
                                                 torch.float32):
        got = np.concatenate([c.numpy().ravel() for c in tree.leaves(tp)])
        want = np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jp)])
        diff = got != want
        if exact:
            assert not diff.any()
        else:
            assert diff.mean() <= 0.005
            assert np.all(np.abs(got - want)[diff] <= np.maximum(2.0**-7 * np.abs(want[diff]), 2.0 * float(jb)))
        assert float(tb) == float(jb)
        for k in ("loss_first", "loss_last"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6 if exact else 1e-3)
        assert tm["wire_bytes"] == M * sum(ops.padded_len(c.numel()) // 8 for c in tree.leaves(tp))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-350m", "jamba-1.5-large-398b", "hubert-xlarge",
                                  "pixtral-12b"])
def test_train_main_runs_new_families_on_cpu(tmp_path, capsys, arch):
    """The trainer takes the MoE, xLSTM, Mamba-hybrid, audio and vision
    families (reduced, on the CPU): finite losses, the packed wire 1/32 of
    f32, a checkpoint that loads back with the MoE router f32."""
    out = tmp_path / "run.json"
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--rounds", "1", "--clients", "2", "--seq", "16",
            "--per-batch", "1", "--local-steps", "1", "--smoke", "--json-out", str(out), "--ckpt-dir", str(tmp_path)]
    assert train.main(argv) == 0
    assert "SMOKE OK" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert rep["wire"]["wire_bytes_f32"] / rep["wire"]["wire_bytes_ideal"] == pytest.approx(32, rel=1e-3)
    like = tip(tbs(tc.reduced(tc.get_config(arch))), prng.key(9))
    back = load_checkpoint(str(tmp_path), 1, like)
    routers = [c for p, c in tree.leaves_with_path(back) if p[-1] == "router"]
    assert all(c.dtype == torch.float32 for c in routers) and len(routers) == (arch in ("qwen3-moe-30b-a3b",
                                                                                        "jamba-1.5-large-398b"))


def test_setup_takes_a_callers_config():
    """``train.setup(args, cfg)`` runs a caller's cut of a config (fewer
    layers at the same widths) through the trainer's own set-up."""
    args = train.parse_args(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--clients", "2", "--seq", "8"])
    cut = dataclasses.replace(micro_family(tc, "qwen3-moe-30b-a3b"), n_layers=1)
    run = train.setup(args, cut)
    assert run.cfg is cut and len(run.params["blocks"]) == 1
    assert run.params["blocks"][0]["ffn"]["w1"].shape == (1, 4, 32, 32)
    assert run.wire["wire_bytes"] == pytree_wire_bytes(run.step.pipeline, run.params, 2)["wire_bytes"]


def test_train_batches_are_the_references():
    """The trainer's round batch: each client's next sequences, tokens and
    labels one position apart."""
    args = train.parse_args(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--clients", "3", "--seq", "8",
                             "--rounds", "2"])
    run = train.setup(args)
    b = train.round_batch(run, args, 1)
    assert b["tokens"].shape == (3, 1, 2, 2, 8) and b["tokens"].dtype == torch.int32
    s = run.streams[2][4:8].reshape(2, 2, 9)
    np.testing.assert_array_equal(b["tokens"][2, 0].numpy(), s[..., :-1])
    np.testing.assert_array_equal(b["labels"][2, 0].numpy(), s[..., 1:])


def test_checkpoints_load_both_ways(tmp_path):
    """A checkpoint the reference writes loads into the port's tree and back:
    same keys, bf16 exact both ways."""
    small = dict(name="starcoder2-micro", d_model=32, n_heads=2, n_kv_heads=1, d_head=16, d_ff=64, vocab=64)
    cfg_j = dataclasses.replace(jc.reduced(jc.get_config("starcoder2-3b")), **small)
    cfg_t = dataclasses.replace(tc.reduced(tc.get_config("starcoder2-3b")), **small)
    # the reference's tree of bf16 arrays, drawn by the port (its init is
    # held to the reference's in test_torch_lm_model.py)
    jp = jax.tree.map(lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16), tip(tbs(cfg_t), prng.key(4)))
    j_specs = jbs(cfg_j)
    assert jax.tree.structure(jp) == jax.tree.structure(j_specs, is_leaf=lambda x: hasattr(x, "logical"))
    assert [a.shape for a in jax.tree.leaves(jp)] == [x.shape for x in jax.tree.leaves(
        j_specs, is_leaf=lambda x: hasattr(x, "logical"))]
    tp = tip(tbs(cfg_t), prng.key(5))
    j_save(str(tmp_path / "j"), 3, jp)
    got = load_checkpoint(str(tmp_path / "j"), 3, tp)
    for a, c in zip(jax.tree.leaves(jp), tree.leaves(got)):
        assert c.dtype == torch.bfloat16
        np.testing.assert_array_equal(c.float().numpy(), np.asarray(a, np.float32))
    path = save_checkpoint(str(tmp_path / "t"), 7, tp, {"arch": cfg_t.name})
    meta = json.loads(open(path + ".json").read())
    assert meta["step"] == 7 and meta["arch"] == cfg_t.name
    assert meta["keys"] == json.loads(open(str(tmp_path / "j" / "ckpt_00000003.npz.json")).read())["keys"]
    back = j_load(str(tmp_path / "t"), 7, jp)
    for a, c in zip(jax.tree.leaves(back), tree.leaves(tp)):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32), c.float().numpy())
    assert latest_step(str(tmp_path / "t")) == 7 and latest_step(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "t"), 7, tip(tbs(dataclasses.replace(cfg_t, d_ff=48)), prng.key(0)))
