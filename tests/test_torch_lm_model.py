"""The port's model zoo (all ten architectures: the dense attention, MoE,
xLSTM and Mamba-hybrid families and the audio and vision frontends)
against the reference's: init bit for bit, the token streams, the
parameter counts, the layers, and prefill logits and the training loss of
every architecture at its reduced size, with parameters (and a frontend's
frames or patches) widened to f32 and in bf16 (the MoE router f32 in
both).

Tolerances, as measured on this CPU at the reduced sizes (2 layers,
d_model 256, seq 128; the MoE's 4 experts; the xLSTM's mLSTM and sLSTM
blocks; jamba's Mamba and attention positions; hubert's 30% masked frames;
pixtral's 16 patches before 112 tokens), the dense family's bars for all
but two bf16 cases (the other families measured: f32 logits <= 5.4e-4 and
losses <= 1.5e-7 relative; bf16 logits <= 0.45 and 0.009 on average,
losses <= 8.4e-5 relative, pixtral's 1.2e-4):
- f32 parameters: loss within rtol 1e-6 (measured <= 4.2e-7); logits within
  atol 2e-3 of logits up to ~5 (measured <= 1.3e-3; the reference's own
  jitted and eager logits differ by up to 2.3e-4 on qwen2's, torch's by
  6.9e-4 from the eager ones: random weights make a sharp softmax); each
  layer alone within rtol 1e-5 and 1e-5 of its largest output;
- bf16 parameters: loss within rtol 2e-4 (measured <= 8.9e-5; every
  projection rounds to bf16 and XLA and torch round different
  intermediates), logits within 0.5 absolute and 0.02 on average;
- bf16 hubert: its loss is a mean over the ~77 masked frames of the 256,
  not over every position, and moves more with the same roundings:
  measured 5.9e-4 at this batch (3.6e-5 to 2.1e-4 at batch seeds 2-8;
  starcoder2's reaches 1.8e-4 and pixtral's 3.5e-4 at some of them), bar
  rtol 1e-3; its logits keep the dense bars (measured 0.35 and 0.0085);
- bf16 jamba: the bf16 in_proj's rare one-step differences (6e-5 of its
  outputs: the matmuls sum in another order) enter the Mamba state, which
  sums them over time: logits within 2.0 and 0.03 on average (measured
  1.57 and 0.024), loss rtol 2e-3 (measured 1.1e-3; 1.9e-5 to 6.1e-4 at
  batch seeds 2-8); with f32 parameters it keeps the dense bars (measured
  1.3e-4 and 1.4e-7).
"""

import dataclasses
import math

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.data import make_lm_streams as j_streams
from repro.models import build_specs as jbs
from repro.models import count_params as j_count
from repro.models import init_params as jip
from repro.models import layers as jL
from repro.models import prefill as jprefill
from repro.models import sample_batch as jsample
from repro.models import train_loss as jloss
from repro_torch import configs as tc
from repro_torch import interop, prng, tree
from repro_torch.data import make_lm_streams as t_streams
from repro_torch.models import build_specs as tbs
from repro_torch.models import count_params as t_count
from repro_torch.models import init_params as tip
from repro_torch.models import layers as tL
from repro_torch.models import prefill as tprefill
from repro_torch.models import sample_batch as tsample
from repro_torch.models import train_loss as tloss

DENSE = ["qwen2-1.5b", "qwen1.5-4b", "minitron-8b", "starcoder2-3b"]
PORTED = DENSE + ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "xlstm-350m", "jamba-1.5-large-398b",
                  "hubert-xlarge", "pixtral-12b"]
SEQ = 128
# bf16 bars (logits max, logits mean, loss rtol): the dense family's, and
# the two measured exceptions of the module docstring
BF16_BARS = {"hubert-xlarge": (0.5, 0.02, 1e-3), "jamba-1.5-large-398b": (2.0, 0.03, 2e-3)}
DENSE_BF16_BARS = (0.5, 0.02, 2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reduced_models():
    """Per ported arch: both configs, both parameter trees and one batch."""
    out = {}
    for arch in PORTED:
        jcfg, tcfg = jc.reduced(jc.get_config(arch)), tc.reduced(tc.get_config(arch))
        jp, tp = jip(jbs(jcfg), jax.random.PRNGKey(0)), tip(tbs(tcfg), prng.key(0))
        out[arch] = (jcfg, tcfg, jp, tp, jsample(jcfg, 2, SEQ, "train", seed=1), tsample(tcfg, 2, SEQ, "train", seed=1))
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_bit_exact(reduced_models, arch):
    """Every leaf of init_params, in the reference's order and under its
    checkpoint key, equals the reference's bit for bit (bf16; the MoE
    router f32)."""
    _, _, jp, tp, _, _ = reduced_models[arch]
    jl, tl = jax.tree_util.tree_leaves_with_path(jp), tree.leaves_with_path(tp)
    assert len(jl) == len(tl)
    for (jpath, a), (tpath, c) in zip(jl, tl):
        assert "/".join(str(k) for k in jpath) == tree.keystr(tpath)
        want = torch.float32 if tpath[-1] == "router" else torch.bfloat16
        assert c.dtype == want and str(a.dtype) == str(want).removeprefix("torch.") and tuple(c.shape) == a.shape
        np.testing.assert_array_equal(c.float().numpy(), np.asarray(a, np.float32))


def test_init_draws_long_leaves_in_blocks(reduced_models, monkeypatch):
    """Leaves drawn a block of flat elements at a time (a block that divides
    none of them) equal the whole draw and the reference's."""
    from repro_torch.models import spec

    _, tcfg, jp, whole, _, _ = reduced_models["qwen2-1.5b"]
    monkeypatch.setattr(spec, "INIT_BLOCK", 100_003)
    blocked = tip(tbs(tcfg), prng.key(0))
    assert max(c.numel() for c in tree.leaves(blocked)) > 2 * spec.INIT_BLOCK
    for a, c, r in zip(tree.leaves(whole), tree.leaves(blocked), jax.tree.leaves(jp)):
        assert torch.equal(a, c)
        np.testing.assert_array_equal(c.float().numpy(), np.asarray(r, np.float32))


def test_make_lm_streams_exact():
    for args in ((0, 4, 1000, 33, 10), (3, 2, 151936, 129, 4), (1, 3, 64, 17, 6, 0.7)):
        for a, c in zip(j_streams(*args), t_streams(*args)):
            assert c.dtype == np.int32
            np.testing.assert_array_equal(c, np.asarray(a))


@pytest.mark.parametrize("arch", jc.ARCH_IDS)
def test_registry_and_counts_match_reference(arch):
    """The registry is the reference's for all ten configs (full and
    reduced), with the same n_params; count_params of every spec tree
    equals the reference's (n_params leaves out the final norm, in both
    packages, counts one norm vector a layer where a layernorm has two, and
    leaves out the mask token and the projector)."""
    jcfg, tcfg = jc.get_config(arch), tc.get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jc.reduced(jcfg)) == dataclasses.asdict(tc.reduced(tcfg))
    assert tcfg.n_params() == jcfg.n_params() and tcfg.n_active_params() == jcfg.n_active_params()
    for j, t in ((jcfg, tcfg), (jc.reduced(jcfg), tc.reduced(tcfg))):
        specs = jax.tree.leaves(jbs(j), is_leaf=lambda s: hasattr(s, "logical"))
        exact = sum(math.prod(s.shape) for s in specs)
        assert t_count(tbs(t)) == exact
        if max(math.prod(s.shape) for s in specs) < 2**31:
            # the reference counts a leaf in int32, which wraps past 2**31
            # elements (minitron-8b's stacked FFN leaves)
            assert j_count(jbs(j)) == exact
    n_leaves = len(tree.leaves(tbs(tcfg), is_leaf=lambda s: hasattr(s, "logical")))
    if arch == "qwen2-1.5b":
        assert t_count(tbs(tcfg)) == 1_777_088_000 and n_leaves == 15
    if arch == "xlstm-350m":  # 7 mLSTM positions of 12 leaves, one sLSTM of 5, embed, head, final norm
        assert t_count(tbs(tcfg)) == 518_855_848 and n_leaves == 92
    if arch == "qwen3-moe-30b-a3b":
        assert t_count(tbs(tcfg)) == 30_532_110_336 and n_leaves == 13
        cut = dataclasses.replace(tcfg, n_layers=4)  # the depth the card's round runs at
        assert t_count(tbs(cut)) == 3_114_813_440 and tbs(cut)["blocks"][0]["ffn"]["w1"].shape == (4, 128, 2048, 768)
    if arch == "hubert-xlarge":  # whole on the card: embed's table, no head, the classifier and the mask token
        assert tcfg.n_params() == 945_131_520 and t_count(tbs(tcfg)) == 945_258_240 and n_leaves == 15
        assert "head" not in tbs(tcfg)["embed"] and tbs(tcfg)["mask_token"].shape == (1280,)
    if arch == "pixtral-12b":  # the card's cut: 2 of 40 layers at the published widths, with the projector
        cut = dataclasses.replace(tcfg, n_layers=2)
        assert cut.n_params() == 1_887_457_280 and t_count(tbs(cut)) == 1_913_676_800 == cut.n_params() + 5120**2 + 5120
    if arch == "jamba-1.5-large-398b":  # 7 Mamba positions of 9 mixer leaves, one attention position
        assert t_count(tbs(tcfg)) == 398_555_111_424 and n_leaves == 114
        cut = dataclasses.replace(tcfg, pattern=("mamba", "attn"), n_layers=2, n_experts=2)  # the card's cut
        assert cut.n_params() == 3_457_056_768 and t_count(tbs(cut)) == 3_457_064_960
        assert tbs(cut)["blocks"][0]["mixer"]["in_proj"].shape == (1, 8192, 32768)
        assert tbs(cut)["blocks"][1]["ffn"]["w1"].shape == (1, 2, 8192, 24576)
    assert tc.ARCH_IDS == jc.ARCH_IDS and set(tc.SHAPES) == set(jc.SHAPES)


def _f32(tp):
    return tree.tree_map(lambda a: a.float(), tp)


@pytest.mark.parametrize("arch", PORTED)
def test_logits_and_loss_f32(reduced_models, arch):
    """With f32 parameters and the batch's frames or patches widened to f32
    too (the reference's layer scan cannot carry hubert's bf16 frames into
    f32 layers)."""
    jcfg, tcfg, jp, tp, jb, tb = reduced_models[arch]
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].float().numpy(), np.asarray(jb[k], np.float32))
    jb = {k: v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v for k, v in jb.items()}
    tb = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in tb.items()}
    jlog = np.asarray(jax.jit(lambda p, b: jprefill(p, b, jcfg))(jp32, jb))
    tlog = tprefill(_f32(tp), tb, tcfg).numpy()
    assert tlog.dtype == np.float32 and tlog.shape == (2, SEQ, tcfg.vocab)
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=2e-3)
    jl = float(jax.jit(lambda p, b: jloss(p, b, jcfg))(jp32, jb))
    np.testing.assert_allclose(float(tloss(_f32(tp), tb, tcfg)), jl, rtol=1e-6)


@pytest.mark.parametrize("arch", PORTED)
def test_logits_and_loss_bf16(reduced_models, arch):
    jcfg, tcfg, jp, tp, jb, tb = reduced_models[arch]
    top, mean, rtol = BF16_BARS.get(arch, DENSE_BF16_BARS)
    jlog = np.asarray(jax.jit(lambda p, b: jprefill(p, b, jcfg))(jp, jb))
    tlog = tprefill(tp, tb, tcfg).numpy()
    assert np.abs(tlog - jlog).max() <= top and np.abs(tlog - jlog).mean() <= mean
    jl = float(jax.jit(lambda p, b: jloss(p, b, jcfg))(jp, jb))
    np.testing.assert_allclose(float(tloss(tp, tb, tcfg)), jl, rtol=rtol)


def test_layers_match_reference_one_by_one(reduced_models):
    """Norms (RMS and layer), RoPE, the QKV projection, attention and the
    FFN (SwiGLU and tanh-GELU) on the same f32 inputs."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64), (2, 64))
    for arch in ("qwen2-1.5b", "starcoder2-3b"):
        jcfg, tcfg, jp, tp, _, _ = reduced_models[arch]
        jblk = jax.tree.map(lambda a: np.asarray(a[0], np.float32), jp["blocks"][0])
        tblk = interop.lm_params_from_numpy(jblk, dtype=torch.float32)
        tblk["norm1"] = {k: v + 0.1 * torch.arange(256) / 256 for k, v in tblk["norm1"].items()}
        jblk["norm1"] = {k: v.numpy() for k, v in tblk["norm1"].items()}
        close = dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tL.apply_norm(tblk["norm1"], torch.from_numpy(x), 1e-5).numpy(),
                                   np.asarray(jax.jit(jL.apply_norm, static_argnums=2)(jblk["norm1"], x, 1e-5)), **close)
        q, k, v = jax.jit(lambda p, h: jL._qkv(p, h, jcfg, pos))(jblk["mixer"], x)
        tq, tk, tv = tL._qkv(tblk["mixer"], torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()))
        for a, c in ((q, tq), (k, tk), (v, tv)):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), **close)
        att = np.asarray(jax.jit(lambda p, h: jL.attention_block(p, h, jcfg, pos))(jblk["mixer"], x))
        np.testing.assert_allclose(tL.attention_block(tblk["mixer"], torch.from_numpy(x), tcfg,
                                                      torch.from_numpy(pos.copy())).numpy(), att,
                                   rtol=1e-5, atol=1e-5 * np.abs(att).max())
        ffn = jax.jit(lambda p, h: jL.ffn_block(p, h, jcfg))(jblk["ffn"], x)
        np.testing.assert_allclose(tL.ffn_block(tblk["ffn"], torch.from_numpy(x), tcfg).numpy(), np.asarray(ffn),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 5, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_masks(window, causal):
    """Several q and kv chunks with GQA: the online softmax equals a plain
    masked softmax, and the reference's chunked_attention; a sliding window
    of w keys sees exactly keys (i - w, i]."""
    rng = np.random.default_rng(window + causal)
    B, S, H, KV, hd = 2, 32, 4, 2, 8
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32) for h in (H, KV, KV))
    kw = dict(causal=causal, window=window, chunk_q=8, chunk_kv=16)
    got = tL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    want = jax.jit(lambda a, b, c: jL.chunked_attention(a, b, c, **kw))(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    allowed = np.ones((S, S), bool)
    if causal:
        allowed &= j <= i
    if window:
        allowed &= j > i - window
    kr = np.repeat(k, H // KV, axis=2)
    vr = np.repeat(v, H // KV, axis=2)
    logits = np.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(hd)
    logits = np.where(allowed, logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), np.einsum("bhqk,bkhd->bqhd", p, vr), rtol=1e-5, atol=1e-5)


def test_starcoder2_sliding_window_changes_logits(reduced_models):
    """At seq 128 the reduced starcoder2's window of 64 masks keys: its
    logits agree with the same model's without a window before position 64
    and differ after it."""
    _, tcfg, _, tp, _, tb = reduced_models["starcoder2-3b"]
    assert tcfg.sliding_window == 64
    windowed = tprefill(_f32(tp), tb, tcfg)
    full = tprefill(_f32(tp), tb, dataclasses.replace(tcfg, sliding_window=0))
    assert torch.equal(windowed[:, :64], full[:, :64])
    assert (windowed[:, 64:] - full[:, 64:]).abs().amax() > 0.1


def test_sample_batch_and_params_carry_across(reduced_models):
    jcfg, tcfg, jp, tp, _, _ = reduced_models["qwen2-1.5b"]
    for kind in ("train", "prefill", "decode"):
        jb, tb = jsample(jcfg, 3, 16, kind, seed=4), tsample(tcfg, 3, 16, kind, seed=4)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    carried = interop.lm_params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    for a, c in zip(tree.leaves(tp), tree.leaves(carried)):
        assert c.dtype == torch.bfloat16 and torch.equal(a, c)
    flat, unravel = interop.ravel_params(tp)
    jflat, _ = jax.flatten_util.ravel_pytree(jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = unravel(flat)
    assert isinstance(back["blocks"], list) and torch.equal(back["blocks"][0]["ffn"]["w1"], tp["blocks"][0]["ffn"]["w1"].float())


def test_mixed_dtype_tree_carries_across(reduced_models, tmp_path):
    """The reduced qwen3-moe's tree (f32 routers among bf16 leaves) carries
    from the reference's numpy leaves with each spec's dtype, ravels in the
    reference's order, and round-trips through a checkpoint the reference
    writes, every leaf exact in its own dtype."""
    from repro.checkpoint import load_checkpoint as j_load
    from repro.checkpoint import save_checkpoint as j_save
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    jcfg, tcfg, jp, tp, _, _ = reduced_models["qwen3-moe-30b-a3b"]
    carried = interop.lm_params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), specs=tbs(tcfg))
    routers = 0
    for (path, a), c in zip(tree.leaves_with_path(tp), tree.leaves(carried)):
        assert c.dtype == a.dtype and torch.equal(a, c)
        routers += path[-1] == "router"
    assert routers == 1 and tp["blocks"][0]["ffn"]["router"].dtype == torch.float32
    flat, _ = interop.ravel_params(tp)
    jflat, _ = jax.flatten_util.ravel_pytree(jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    j_save(str(tmp_path / "j"), 1, jp)
    for a, c in zip(tree.leaves(tp), tree.leaves(load_checkpoint(str(tmp_path / "j"), 1, tp))):
        assert c.dtype == a.dtype and torch.equal(a, c)
    save_checkpoint(str(tmp_path / "t"), 2, tp)
    for a, c in zip(jax.tree.leaves(jp), jax.tree.leaves(j_load(str(tmp_path / "t"), 2, jp))):
        assert c.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(c, np.float32), np.asarray(a, np.float32))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "hubert-xlarge", "pixtral-12b"])
def test_new_trees_carry_across_and_checkpoint(reduced_models, arch, tmp_path):
    """Mamba's nine leaves a position (beside jamba's f32 MoE router), the
    classifier and mask token and the projector carry from the reference's numpy leaves with their specs'
    dtypes, ravel in the reference's order, and go through checkpoints both
    ways, every leaf exact."""
    from repro.checkpoint import load_checkpoint as j_load
    from repro.checkpoint import save_checkpoint as j_save
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    jcfg, tcfg, jp, tp, _, _ = reduced_models[arch]
    new = {"jamba-1.5-large-398b": ("conv_w", "a_log", "d_skip", "dt_proj"), "hubert-xlarge": ("classifier", "mask_token"),
           "pixtral-12b": ("projector",)}[arch]
    names = {tree.keystr(p).split("/")[-1].strip("[]'") for p, _ in tree.leaves_with_path(tp)}
    assert set(new) <= names
    carried = interop.lm_params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), specs=tbs(tcfg))
    for (path, a), c in zip(tree.leaves_with_path(tp), tree.leaves(carried)):
        assert c.dtype == a.dtype == (torch.float32 if path[-1] == "router" else torch.bfloat16) and torch.equal(a, c)
    flat, _ = interop.ravel_params(tp)
    jflat, _ = jax.flatten_util.ravel_pytree(jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    j_save(str(tmp_path / "j"), 1, jp)
    for a, c in zip(tree.leaves(tp), tree.leaves(load_checkpoint(str(tmp_path / "j"), 1, tp))):
        assert c.dtype == a.dtype and torch.equal(a, c)
    save_checkpoint(str(tmp_path / "t"), 2, tp)
    for a, c in zip(jax.tree.leaves(jp), jax.tree.leaves(j_load(str(tmp_path / "t"), 2, jp))):
        assert c.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(c, np.float32), np.asarray(a, np.float32))
