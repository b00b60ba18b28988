"""The port's k-bit and mixed-width wires against the JAX package's.

Exact against the jitted reference (every array an argument of the jitted
function: XLA folds a closed-over constant in other float steps): the
level primitives (n % 8 != 0), the
randomized-response level draw (an 8-bit randint in the reference, the
int32 draw here), ``packed_quantize_batch`` bytes and residuals with and
without RR and error feedback, the kernel wire's realigned planes,
``rr_gamma``, the L-level estimate and the mixed-width merge; the k = 1
wire reproduces ``tests/data/k1_golden.npz`` byte for byte. End to end,
FLSimulation at k = 2 with error feedback on the kernel wire and with
per-client widths 1, 2 and 4 under DP against the reference's, with the bars of
``tests/test_torch_round.py``. This file's task (``_task``, ``_both``,
``_hold``) serves ``tests/test_torch_sparse.py`` and
``tests/test_torch_tree.py`` too.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import build_pipeline as jbuild  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.core import quantizer as jq  # noqa: E402
from repro.data import make_classification, partition_label_skew  # noqa: E402
from repro.fl import FLConfig as JConfig, FLSimulation as JSim  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import build_pipeline, hetero_client_groups, privacy_loss, rr_gamma  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulation  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

N, PER_CLIENT, HIDDEN = 8, 30, 4  # d = 3,210
BASE = dict(n_clients=N, rounds=2, local_epochs=1, pack_chunk=512)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "k1_golden.npz")


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _task():
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=100)
    parts = partition_label_skew(ytr, N, 2, PER_CLIENT, seed=1)
    p0 = jax.tree_util.tree_map(np.asarray, jv.init_mlp(jax.random.PRNGKey(0), hidden=HIDDEN))
    return p0, np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts]), {"x": xte, "y": yte}


def _both(**kw):
    """FLSimulation of both packages on one config (BASE + kw), every round
    recorded: (reference sim, its history, port sim, its history)."""
    cfg = dict(BASE, **kw)
    p0, cx, cy, test = _task()
    js = JSim(JConfig(**cfg), p0, functools.partial(jv.xent_loss, jv.mlp_logits),
              functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)
    jh = js.run(eval_every=1)
    ts = FLSimulation(FLConfig(**cfg), p0, functools.partial(tv.xent_loss, tv.mlp_logits),
                      functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")
    th = ts.run(eval_every=1)
    return js, jh, ts, th


def _hold(js, jh, ts, th):
    """The bars of tests/test_torch_round.py: b exact every round; the loss
    within rtol 1e-6 (XLA contracts the prox step into FMAs on the CPU, the
    port rounds every op); w_global within 1e-5 but for at most 0.1% of the
    coordinates, where a wire bit may flip on a uniform within an ulp of
    its probability."""
    assert [h["b"] for h in th] == [h["b"] for h in jh]
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=1e-6)
    diff = np.abs(np.asarray(js.w_global) - ts.w_global.numpy())
    assert (diff > 1e-5).sum() <= 0.001 * diff.size, diff.max()


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_level_primitives_against_reference(bits):
    """Exact against the jitted reference, n % 8 != 0: the packed planes
    and their round trip (n = 13 and 37), the grid positions, the rounded
    levels and their grid values (the reference's ``2b/(L-1)`` folds into
    ``2b * f32(1/(L-1))`` and ``-b + l * step`` into an FMA under jit);
    level_probs to 1e-6."""
    rng = np.random.default_rng(bits)
    for n in (13, 37):
        levels = rng.integers(0, 1 << bits, (3, n)).astype(np.uint8)
        packed = tq.pack_levels(_t(levels), bits)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_levels(jnp.asarray(levels), bits)))
        np.testing.assert_array_equal(tq.unpack_levels(packed, n, bits).numpy(), levels)
    delta = (0.02 * rng.standard_normal((3, n))).astype(np.float32)
    b = np.abs(0.01 * rng.standard_normal(n)).astype(np.float32)
    b[:2] = 0.0  # dead coordinates sit at the grid midpoint
    u = rng.random((3, n), dtype=np.float32)
    want = jax.jit(lambda u, x, b, lv: (jq.level_positions(x, b, bits), jq.quantize_levels(u, x, b, bits),
                                        jq.dequantize_levels(lv, b, bits), jq.level_probs(x, b, bits)))(
        u, delta, b, levels)
    got = (tq.level_positions(_t(delta), _t(b), bits), tq.quantize_levels(_t(u), _t(delta), _t(b), bits),
           tq.dequantize_levels(_t(levels), _t(b), bits))
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(tq.level_probs(_t(delta), _t(b), bits).numpy(), np.asarray(want[3]), atol=1e-6)


@pytest.mark.parametrize("span", [4, 16])
def test_rr_level_draw_is_the_int32_draw(span):
    """The reference draws the RR level as ``randint(..., 0, L, uint8)``:
    the low byte of the 32-bit word, whose multiplier term vanishes for a
    span dividing 256; the port's int32 draw equals it (exact)."""
    keys = jax.random.split(jax.random.PRNGKey(span), 5)
    want = np.stack([np.asarray(jax.random.randint(k, (777,), 0, span, jnp.uint8)) for k in keys])
    got = prng.randint(prng.split(prng.key(span), 5), (777,), 0, span)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,rr,ef", [(2, False, False), (2, True, True), (4, False, True), (4, True, False),
                                        (1, True, True)])
def test_packed_quantize_batch_against_jitted_reference(bits, rr, ef):
    """k-bit compression of 7 clients at d = 150 in chunks of 64 (a tail
    in the last chunk), rows keyed from cohort position 3: the wire bytes
    exact, the residual of the emitted level exact; RR with a
    per-coordinate gamma (at k = 1 too, which takes the level path)."""
    rng = np.random.default_rng(bits)
    m, d = 7, 150
    deltas = (0.02 * rng.standard_normal((m, d))).astype(np.float32)
    b = np.full(d, 0.03, np.float32)
    gamma = rng.uniform(0.0, 0.6, d).astype(np.float32) if rr else None
    want = jax.jit(lambda k, x, b, g: jq.packed_quantize_batch(k, x, b, bits=bits, chunk=64, want_residual=ef,
                                                               row_offset=3, gamma=g))(
        jax.random.PRNGKey(9), deltas, b, gamma)
    got = tq.packed_quantize_batch(prng.key(9), _t(deltas), _t(b), bits=bits, chunk=64, want_residual=ef,
                                   row_offset=3, gamma=None if gamma is None else _t(gamma))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if ef:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("bits", [2, 4])
def test_kernel_wire_planes_and_plain_pair(bits):
    """``ops.stoch_quant_compress_batch(bits=)`` realigns each plane to
    padded_len(d)/8 bytes, equal to the reference's kernel wire; the plain
    pair of kernels/ref.py equals the reference's (bytes, residual and
    estimate exact)."""
    rng = np.random.default_rng(bits + 10)
    m, d = 5, 1500
    deltas = (0.02 * rng.standard_normal((m, d))).astype(np.float32)
    b = np.full(d, 0.03, np.float32)
    want, _ = jax.jit(lambda k, x, b: jops.stoch_quant_compress_batch(k, x, b, chunk=512, bits=bits))(
        jax.random.PRNGKey(2), deltas, b)
    got, _ = tops.stoch_quant_compress_batch(prng.key(2), _t(deltas), _t(b), chunk=512, bits=bits)
    assert got.shape == (m, bits * tops.padded_len(d) // 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    from repro.kernels import ref as jref

    u = rng.random((m, 1024), dtype=np.float32)
    x = (0.02 * rng.standard_normal((m, 1024))).astype(np.float32)
    bb = np.full(1024, 0.03, np.float32)
    wp, wr = jax.jit(lambda x, u, bb: jax.vmap(lambda xr, ur: jref.kbit_quant_compress_ref(
        xr, bb, ur, bits=bits, want_residual=True))(x, u))(x, u, bb)
    gp, gr = tref.kbit_quant_compress_ref(_t(x), _t(bb), _t(u), bits=bits, want_residual=True)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    want_est = jax.jit(lambda p, bb: jref.kbit_aggregate_ref(p, bb, bits))(np.asarray(wp), bb[:1000])
    np.testing.assert_array_equal(tref.kbit_aggregate_ref(gp, _t(bb[:1000]), bits).numpy(), np.asarray(want_est))


# ---------------------------------------------------------------------------
# The k = 1 golden wire
# ---------------------------------------------------------------------------


def test_k1_golden():
    """The golden capture's scenario (tools/capture_k1_golden.py: 12
    clients, d = 50, chunks of 64, b = 0.4, error feedback): the dense,
    client-chunked and kernel wires' bytes and counts exact; theta and the
    residuals within the golden test's 1e-6."""
    g = np.load(GOLDEN)
    m, d = 12, 50
    deltas = _t(0.1 * jax.random.normal(jax.random.PRNGKey(1234), (m, d), jnp.float32))
    key, b, res0 = prng.key(7), torch.tensor(0.4), torch.zeros(m, d)
    pipe = build_pipeline("probit_plus", error_feedback=True, chunk=64)
    wire, res = pipe.compress_wire(key, deltas, b, res0)
    np.testing.assert_array_equal(wire.packed.numpy(), g["dense_packed"])
    np.testing.assert_array_equal(tq.packed_counts(wire.packed).numpy(), g["dense_counts"])
    np.testing.assert_array_equal(wire.b.numpy(), g["dense_b"])
    np.testing.assert_allclose(pipe.estimate(wire).numpy(), g["dense_theta"], atol=1e-6)
    np.testing.assert_allclose(res.numpy(), g["dense_residuals"], atol=1e-6)
    comp, server = pipe.compressor, pipe.server
    counts, parts = server.init_counts(comp.wire_bytes(d)), []
    for g0 in range(0, m, 4):
        w, r = comp.compress(key, deltas[g0:g0 + 4], b, res0[g0:g0 + 4], row_offset=g0)
        counts = server.accumulate_counts(counts, w.packed)
        parts.append(r)
    np.testing.assert_array_equal(counts.numpy(), g["stream_counts"])
    np.testing.assert_allclose(server.finalize(counts, m, comp.b_vector(d, b)).numpy(), g["stream_theta"],
                               atol=1e-6)
    np.testing.assert_allclose(torch.cat(parts).numpy(), g["stream_residuals"], atol=1e-6)
    kpipe = build_pipeline("probit_plus", use_kernels=True, chunk=64)
    kwire, _ = kpipe.compress_wire(key, deltas, b, res0)
    np.testing.assert_array_equal(kwire.packed.numpy(), g["kernel_packed"])
    np.testing.assert_allclose(kpipe.estimate(kwire).numpy(), g["kernel_theta"], atol=1e-6)


# ---------------------------------------------------------------------------
# Privacy, the L-level estimate and the mixed-width merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,eps", [(2, 0.1), (4, 0.5), (4, 3.0)])
def test_rr_gamma_and_privacy_loss(bits, eps):
    """rr_gamma exact against the jitted reference (its denominator is one
    FMA there), b = 0 included; privacy_loss of the one-bit wire, the raw
    k-bit rounding and the RR-mixed wire within rtol 1e-5 and atol 1e-5
    (differences of the logs of nearly equal probabilities, which carry
    the last bit of either library's arithmetic), and the RR wire's loss
    within eps at the Theorem's sensitivity."""
    rng = np.random.default_rng(bits)
    b = np.abs(0.01 * rng.standard_normal(500)).astype(np.float32)
    b[:3] = 0.0
    want = jax.jit(lambda b: jpriv.rr_gamma(eps, 2e-4, b, bits))(b)
    np.testing.assert_array_equal(rr_gamma(eps, 2e-4, _t(b), bits).numpy(), np.asarray(want))
    bb = np.full(64, 0.05, np.float32)
    da = (0.02 * rng.standard_normal(64)).astype(np.float32)
    db = da.copy()
    db[0] += 2e-4
    gamma = rr_gamma(eps, 2e-4, _t(bb), bits)
    for kw in (dict(), dict(bits=bits), dict(bits=bits, gamma=gamma)):
        jkw = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v) for k, v in kw.items()}
        got = privacy_loss(_t(da), _t(db), _t(bb), **kw).item()
        np.testing.assert_allclose(got, float(jpriv.privacy_loss(da, db, bb, **jkw)), rtol=1e-5, atol=1e-5)
    assert privacy_loss(_t(da), _t(db), _t(bb), bits=bits, gamma=gamma).item() <= eps * (1 + 1e-5)


@pytest.mark.parametrize("bits", [2, 4])
def test_kbit_estimate_against_reference(bits):
    """kbit_estimate_from_counts exact against the jitted reference: M a
    number (a multiply by f32(1/M) there), with and without the RR
    debias."""
    rng = np.random.default_rng(bits)
    m, d = 37, 999
    counts = rng.integers(0, m + 1, (bits, d)).astype(np.int32)
    b = np.abs(0.01 * rng.standard_normal(d)).astype(np.float32)
    gamma = rng.uniform(0.05, 0.9, d).astype(np.float32)
    for g in (None, gamma):
        want = jax.jit(lambda c, b, g: jagg.kbit_estimate_from_counts(c, m, b, bits, g))(counts, b, g)
        got = tagg.kbit_estimate_from_counts(_t(counts), m, _t(b), bits, None if g is None else _t(g))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hetero_groups_and_merged_estimate():
    """Mixed widths (1, 1, 2, 2, 2, 4, 4, 1): the same groups, every group's
    wire bytes exact, and the merged estimate exact against the jitted
    reference (each step of its weighted sum one FMA, its division by the
    constant weight sum a multiply by the reciprocal), weighted too."""
    cb = (1, 1, 2, 2, 2, 4, 4, 1)
    assert hetero_client_groups(cb) == jagg.hetero_client_groups(cb) == ((0, 2, 1), (2, 5, 2), (5, 7, 4), (7, 8, 1))
    with pytest.raises(ValueError, match="bit-widths must be in"):
        hetero_client_groups((1, 3))
    rng = np.random.default_rng(0)
    deltas = (0.01 * rng.standard_normal((8, 1200))).astype(np.float32)
    jp, tp = jbuild("probit_plus", client_bits=cb, chunk=256), build_pipeline("probit_plus", client_bits=cb, chunk=256)
    jw, _ = jax.jit(lambda k, x: jp.compress_wire(k, x, jnp.float32(0.02), jnp.zeros_like(x)))(
        jax.random.PRNGKey(3), deltas)
    tw, _ = tp.compress_wire(prng.key(3), _t(deltas), torch.tensor(0.02), torch.zeros(8, 1200))
    assert [w.bits for w in tw.wires] == [1, 2, 4, 1] and tw.n_clients == 8
    for a, c in zip(jw.wires, tw.wires):
        np.testing.assert_array_equal(c.packed.numpy(), np.asarray(a.packed))
    weights = (1.0 + np.arange(8) % 3).astype(np.float32) ** -0.5
    np.testing.assert_array_equal(tp.estimate(tw).numpy(), np.asarray(jax.jit(jp.estimate)(jw)))
    want_w = np.asarray(jax.jit(jp.estimate)(jw, jnp.asarray(weights)))
    np.testing.assert_allclose(tp.estimate(tw, _t(weights)).numpy(), want_w, rtol=1e-6, atol=2e-8)


# ---------------------------------------------------------------------------
# Rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(wire_bits=2, error_feedback=True, use_kernels=True),
    dict(client_bits=(1, 1, 2, 2, 2, 4, 4, 1), dp_epsilon=0.5, byz_frac=0.25, attack="sign_flip"),
], ids=["k2-ef-kernel_wire", "client_bits-dp-sign_flip"])
def test_flsimulation_against_reference(kw):
    """Two rounds of both packages, held to _hold's bars: the 2-bit kernel
    wire (plain on the CPU) with error feedback, and per-client widths 1, 2
    and 4 under DP (the one-bit group on the range margin, the others on
    randomized response) with 25% sign_flip Byzantines. The 4-bit DP wire
    runs end to end in tests/test_torch_tree.py's trimmed tree."""
    _hold(*_both(**kw))


def test_kbit_stream_and_async_equal_dense():
    """The k-bit wire through the streamed round (chunks of 3, not dividing
    M) and the asynchronous round at a full buffer, zero latency and decay
    equals the dense round exactly (every plane and b), error feedback on."""
    p0, cx, cy, test = _task()
    runs = []
    for extra in (dict(), dict(client_chunk=3), dict(async_buffer=N)):
        sim = FLSimulation(FLConfig(**dict(BASE, wire_bits=4, error_feedback=True, **extra)), p0,
                           functools.partial(tv.xent_loss, tv.mlp_logits), functools.partial(tv.accuracy, tv.mlp_logits),
                           cx, cy, test, device="cpu")
        sim.run(eval_every=2)
        runs.append(sim)
    for sim in runs[1:]:
        for f in ("w_global", "w_locals", "residuals"):
            assert torch.equal(getattr(sim, f), getattr(runs[0], f)), f
        assert sim.b_state.b.item() == runs[0].b_state.b.item()
