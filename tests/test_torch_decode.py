"""The port's decode path (repro_torch.models: init_cache, serve_step, the
attention, Mamba, mLSTM and sLSTM decode steps and caches;
interop.lm_cache_from_numpy) against the reference's on the CPU, at the
reduced configs (2 layers, d_model 256), and the port's versions of the
reference's decode tests in tests/test_arch_smoke.py.

Tolerances, as measured on this CPU. No step is bit for bit: XLA's and
torch's matmuls sum in other orders (the attention's q projection already
differs in ~90% of its f32 entries), and their exp, log-sigmoid and pow
differ by ulps (ROADMAP C).
- Each decode step alone, from the reference's cache (12 steps, each fed
  the reference's cache), f32 parameters: the output and every f32 cache
  leaf within 1e-5 of its largest entry (measured <= 6.7e-6, the full
  attention's output); a bf16 cache leaf (the KV cache, the convolutions'
  last inputs) within one bf16 step, 2 ** -7 of its largest entry, in at
  most 0.1% of its entries (measured 2 ** -8 in 0.03%: an f32 ulp moves a
  bf16 rounding). bf16 parameters: every bf16 rounding of a gate or a
  projection that lands on the other side moves an exp, so the outputs'
  bars are the mixer's own, 1e-5 for attention and the sLSTM (measured
  8.8e-7 and 0), 2 ** -6 for Mamba (measured 6.5e-3) and 2 ** -4 for the
  mLSTM (measured 0.042: a one-step change of its bf16 input gate moves
  exp(li - m) by ~3%); the f32 cache leaves within the same bars, and
  bf16 leaves as with f32 parameters.
- serve_step over 8 positions, each package carrying its own caches,
  f32 parameters: the KV cache stays bf16, as the reference's does, and a
  key that lands on the other side of a bf16 rounding moves the next
  positions' logits by ~1e-3: logits within 5e-3 absolute on logits up to
  ~4.5 (measured 3.5e-3 for the MoE, <= 7.3e-4 for the others, 6.2e-6 for
  a ring of 3 slots on qwen2), f32 cache leaves within 1e-5 of their
  largest entries (measured <= 1.0e-6), bf16 leaves within one bf16 step;
  bf16 parameters: the prefill tests' bf16 bars, logits within 0.5
  absolute and 0.02 on average (jamba 2.0 and 0.03; measured <= 0.16 and
  0.0046, jamba 0.23 and 0.011), every cache leaf within 2 ** -5 of its
  largest entry (measured <= 8.7e-3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import build_specs as jbs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jip
from repro.models import layers as jL
from repro.models import serve_step as jserve
from repro.models import ssm as jS
from repro.models import xlstm as jX
from repro_torch import configs as tc
from repro_torch import prng, tree
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import build_specs as tbs
from repro_torch.models import init_cache, prefill, serve_step
from repro_torch.models import init_params as tip
from repro_torch.models import layers as tL
from repro_torch.models import ssm as tS
from repro_torch.models import xlstm as tX

SERVED = ["qwen2-1.5b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "xlstm-350m"]
DECODERS = [a for a in tc.ARCH_IDS if a != "hubert-xlarge"]
BF16_STEP = 2.0**-7  # one bf16 rounding step, relative to the largest entry
# mixer: (arch, specs, reference step, port step, reference cache, port cache, window or None)
MIXERS = {
    "attn-full": ("qwen2-1.5b", jL.attn_specs, jL.decode_attention_block, tL.decode_attention_block,
                  jL.init_attn_cache, tL.init_attn_cache, 0),
    "attn-ring": ("qwen2-1.5b", jL.attn_specs, jL.decode_attention_block, tL.decode_attention_block,
                  jL.init_attn_cache, tL.init_attn_cache, 5),
    "mamba": ("jamba-1.5-large-398b", jS.mamba_specs, jS.mamba_decode_step, tS.mamba_decode_step,
              jS.init_mamba_cache, tS.init_mamba_cache, None),
    "mlstm": ("xlstm-350m", jX.mlstm_specs, jX.mlstm_decode_step, tX.mlstm_decode_step, jX.init_mlstm_cache,
              tX.init_mlstm_cache, None),
    "slstm": ("xlstm-350m", jX.slstm_specs, jX.slstm_decode_step, tX.slstm_decode_step, jX.init_slstm_cache,
              tX.init_slstm_cache, None),
}
BF16_OUT_BARS = {"attn-full": 1e-5, "attn-ring": 1e-5, "mamba": 2.0**-6, "mlstm": 2.0**-4, "slstm": 1e-5}
STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    return jc.reduced(jc.get_config(arch)), tc.reduced(tc.get_config(arch))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _shapes(cache) -> tuple:
    """A cache's tree structure with its leaves' shapes (either package's)."""
    return jax.tree.structure(tree.tree_map(lambda v: 0, cache)), [tuple(v.shape) for v in tree.leaves(cache)]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


def _check_cache(got: dict, want: dict, f32_bar: float, bf16_frac: float = 1e-3):
    for k, w in want.items():
        w_np = np.asarray(w, np.float32)
        if got[k].dtype == torch.bfloat16:
            assert str(w.dtype) == "bfloat16", k
            assert _rel(got[k], w_np) <= max(BF16_STEP, f32_bar), k
            assert (got[k].float().numpy() != w_np).mean() <= max(bf16_frac, f32_bar), k
        else:
            assert got[k].dtype == torch.float32 and str(w.dtype) == "float32", k
            assert _rel(got[k], w_np) <= f32_bar, k


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_decode_step_alone_matches_reference(mixer, dtype):
    """Each mixer's step, given the reference's cache after every step (the
    ring of 5 slots wraps twice over the 12 steps); the Mamba biases and
    decays drawn away from their init so that every path carries signal."""
    arch, specs, jstep, tstep, jinit, tinit, window = MIXERS[mixer]
    jcfg, tcfg = _configs(arch)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), jip(specs(jcfg), jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    if "a_log" in p:
        d_in, ds = p["a_log"].shape
        p.update(dt_bias=(0.5 * rng.standard_normal(d_in)).astype(np.float32),
                 a_log=(0.5 * rng.standard_normal((d_in, ds))).astype(np.float32))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jp, tp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p), lm_params_from_numpy(p, dtype=tdt)
    b = 2
    xs = rng.standard_normal((STEPS, b, 1, jcfg.d_model)).astype(np.float32)
    if window is None:
        fn = jax.jit(lambda p, x, c, pos: jstep(p, x, c, jcfg))
        cache = jinit(jcfg, b)
        assert _shapes(cache) == _shapes(tinit(tcfg, b))
    else:
        fn = jax.jit(lambda p, x, c, pos: jstep(p, x, c, jcfg, pos, window))
        cache = jinit(jcfg, b, window or STEPS)
    f32_bar = 1e-5 if dtype == "f32" else BF16_OUT_BARS[mixer]
    for t in range(STEPS):
        mine = lm_cache_from_numpy(_np(cache))
        jy, cache = fn(jp, jnp.asarray(xs[t], jdt), cache, jnp.int32(t))
        x = torch.from_numpy(xs[t]).to(tdt)
        ty, new = tstep(tp, x, mine, tcfg) if window is None else tstep(tp, x, mine, tcfg, t, window)
        assert ty.dtype == tdt and ty.shape == x.shape
        assert _rel(ty, jy) <= f32_bar, (t, _rel(ty, jy))
        _check_cache(new, cache, f32_bar)


def test_mlstm_first_step_from_the_stabilizer_start(port_models):
    """The first step sees m = -1e30: the old state's decay is exactly 0,
    exp(-m_new) and the output stay finite, even with an input gate far
    below 0 (no causal mask here, so the prefill's masked exponent is not
    needed)."""
    tcfg, params = port_models("xlstm-350m")
    p = {k: v[0].float() for k, v in params["blocks"][0]["mixer"].items()}
    p["bi"] = torch.full_like(p["bi"], -60.0)
    cache = tX.init_mlstm_cache(tcfg, 2)
    assert (cache["m"] == tX.M_INIT).all()
    x = torch.randn(2, 1, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    y, new = tX.mlstm_decode_step(p, x, cache, tcfg)
    assert torch.isfinite(y).all() and all(torch.isfinite(v).all() for v in new.values())
    assert torch.isfinite(torch.exp(-new["m"])).all() and (new["m"] < -50).all()
    y2, new2 = tX.mlstm_decode_step(p, x, new, tcfg)
    assert torch.isfinite(y2).all() and torch.isfinite(new2["c"]).all()
    s_cache = tX.init_slstm_cache(tcfg, 2)
    ys, s_new = tX.slstm_decode_step({k: v[0].float() for k, v in params["blocks"][1]["mixer"].items()}, x, s_cache,
                                     tcfg)
    assert torch.isfinite(ys).all() and all(torch.isfinite(v).all() for v in s_new.values())


@pytest.fixture(scope="module")
def served():
    """Per served arch: both configs, the reference's bf16 parameters and
    their numpy f32 copy (built on first use)."""
    out = {}

    def get(arch):
        if arch not in out:
            jcfg, tcfg = _configs(arch)
            jp = jip(jbs(jcfg), jax.random.PRNGKey(0))
            out[arch] = (jcfg, tcfg, jp, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
        return out[arch]

    return get


def _serve_both(served, arch, dtype, window=0, positions=8, cache_len=8):
    """Both packages' serve_step over ``positions`` tokens, each carrying its
    own cache: the logits of every position and the final caches."""
    jcfg, tcfg, jp, p_np = served(arch)
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = lm_params_from_numpy(p_np, dtype=torch.float32)
    else:
        tp = lm_params_from_numpy(p_np, specs=tbs(tcfg))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, positions)).astype(np.int32)
    step = jax.jit(lambda p, c, tok, pos: jserve(p, c, {"tokens": tok}, pos, jcfg, window))
    jcache, tcache = jinit_cache(jcfg, 2, cache_len), init_cache(tcfg, 2, cache_len)
    assert _shapes(jcache) == _shapes(tcache)
    jl, tl = [], []
    for t in range(positions):
        lg, jcache = step(jp, jcache, toks[:, t : t + 1], jnp.int32(t))
        jl.append(np.asarray(lg))
        lg, tcache = serve_step(tp, tcache, {"tokens": torch.from_numpy(toks[:, t : t + 1]).long()}, t, tcfg, window)
        assert lg.dtype == torch.float32 and lg.shape == (2, tcfg.vocab)
        tl.append(lg.numpy())
    return np.stack(jl, 1), np.stack(tl, 1), _np(jcache), tcache


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", SERVED)
def test_serve_step_matches_reference(served, arch, dtype):
    want, got, jcache, tcache = _serve_both(served, arch, dtype)
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "f32":
        assert diff.max() <= 5e-3, diff.max()
    else:
        bar_max, bar_mean = (2.0, 0.03) if arch == "jamba-1.5-large-398b" else (0.5, 0.02)
        assert diff.max() <= bar_max and diff.mean() <= bar_mean, (diff.max(), diff.mean())
    for want_c, got_c in zip(jcache, tcache):
        for k in want_c:
            assert tuple(got_c[k].shape) == want_c[k].shape and str(got_c[k].dtype)[6:] == str(want_c[k].dtype), k
            bf16 = got_c[k].dtype == torch.bfloat16
            bar = 2.0**-5 if dtype == "bf16" else BF16_STEP if bf16 else 1e-5
            assert _rel(got_c[k], want_c[k]) <= bar, (k, _rel(got_c[k], want_c[k]))


def test_serve_step_ring_matches_reference(served):
    """serve_step with a ring of 3 slots over 8 positions, f32."""
    want, got, jcache, tcache = _serve_both(served, "qwen2-1.5b", "f32", window=3, cache_len=3)
    assert np.abs(got - want).max() <= 5e-3
    for want_c, got_c in zip(jcache, tcache):
        _check_cache(got_c, want_c, 1e-5, bf16_frac=1e-2)


def test_lm_cache_from_numpy_keeps_each_leafs_dtype():
    jcfg, tcfg = _configs("jamba-1.5-large-398b")
    jcache = _np(jinit_cache(jcfg, 2, 4))
    jcache[1]["k"] = np.asarray(jnp.full(jcache[1]["k"].shape, 1.5, jnp.bfloat16))
    got = lm_cache_from_numpy(jcache)
    want = init_cache(tcfg, 2, 4)
    for (path, g), w in zip(tree.leaves_with_path(got), tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
    assert (got[1]["k"] == 1.5).all() and (got[0]["ssm"] == 0).all()
    got[1]["k"].zero_()  # a copy, not a view of the numpy array
    assert (np.asarray(jcache[1]["k"], np.float32) == 1.5).all()


# -- the port's versions of tests/test_arch_smoke.py's decode tests ----------

@pytest.fixture(scope="module")
def port_models():
    out = {}

    def get(arch):
        if arch not in out:
            cfg = tc.reduced(tc.get_config(arch))
            out[arch] = (cfg, tip(tbs(cfg), prng.key(0)))
        return out[arch]

    return get


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step(arch, port_models):
    cfg, params = port_models(arch)
    cache = init_cache(cfg, 2, 32)
    before = [(p, tuple(v.shape), v.dtype) for p, v in tree.leaves_with_path(cache)]
    logits, cache2 = serve_step(params, cache, {"tokens": torch.zeros((2, 1), dtype=torch.long)}, 0, cfg)
    assert logits.shape == (2, cfg.vocab)
    assert torch.isfinite(logits).all(), arch
    assert [(p, tuple(v.shape), v.dtype) for p, v in tree.leaves_with_path(cache2)] == before


def test_encoder_only_has_no_decode_path():
    cfg = tc.reduced(tc.get_config("hubert-xlarge"))
    with pytest.raises(ValueError, match="encoder-only"):
        serve_step({}, init_cache(cfg, 1, 4), {"tokens": torch.zeros((1, 1), dtype=torch.long)}, 0, cfg)


def test_position_past_the_cache_is_refused(port_models):
    """The reference's cache write clamps a position past the cache to the
    last slot; the port refuses it."""
    cfg, params = port_models("qwen2-1.5b")
    with pytest.raises(ValueError, match="past the cache"):
        serve_step(params, init_cache(cfg, 1, 4), {"tokens": torch.zeros((1, 1), dtype=torch.long)}, 4, cfg)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "starcoder2-3b", "jamba-1.5-large-398b", "qwen3-moe-30b-a3b"])
def test_decode_matches_prefill(arch, port_models):
    """Autoregressive decode reproduces prefill logits position by position
    (the reference's bar, atol 0.25 in bf16)."""
    cfg, params = port_models(arch)
    s = 8
    toks = prng.randint(prng.key(5), (1, s), 0, cfg.vocab)
    pl = prefill(params, {"tokens": toks}, cfg)
    cache = init_cache(cfg, 1, s)
    outs = []
    for t in range(s):
        lg, cache = serve_step(params, cache, {"tokens": toks[:, t : t + 1]}, t, cfg)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(), pl.numpy(), atol=0.25)


def test_sliding_window_ring_decode(port_models):
    """Ring-buffer decode (window < history) stays finite and matches the
    full-cache decode while the history fits the window."""
    cfg, params = port_models("qwen2-1.5b")
    w = 8
    toks = prng.randint(prng.key(9), (1, 12), 0, cfg.vocab)
    ring, full = init_cache(cfg, 1, w), init_cache(cfg, 1, 12)
    for t in range(12):
        lr, ring = serve_step(params, ring, {"tokens": toks[:, t : t + 1]}, t, cfg, window=w)
        lf, full = serve_step(params, full, {"tokens": toks[:, t : t + 1]}, t, cfg)
        if t < w:
            np.testing.assert_allclose(lr.numpy(), lf.numpy(), atol=0.25)
    assert torch.isfinite(lr).all()


def test_mlstm_chunked_matches_sequential_decode():
    """The chunkwise-parallel mLSTM agrees with the O(1) sequential decode
    cell (the reference's bars, atol 2e-3 and rtol 1e-2, f32)."""
    cfg = tc.reduced(tc.get_config("xlstm-350m"))
    p = {k: v.float() for k, v in tip(tX.mlstm_specs(cfg), prng.key(2)).items()}
    x = 0.5 * prng.normal(prng.key(3), (1, 16, cfg.d_model))
    y_chunk = tX.mlstm_block(p, x, cfg, chunk=4)
    cache = {k: v.float() for k, v in tX.init_mlstm_cache(cfg, 1).items()}
    ys = []
    for t in range(16):
        y, cache = tX.mlstm_decode_step(p, x[:, t : t + 1], cache, cfg)
        ys.append(y)
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, dim=1).numpy(), atol=2e-3, rtol=1e-2)
    assert math.isfinite(float(torch.cat(ys).abs().max()))
