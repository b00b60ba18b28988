"""The paper's theorem layer on the port: the unpacked one-bit API, the
functional servers and ``AggregatorPipeline.__call__``, on the CPU.

Parity with the JAX reference, bit for bit on seeded inputs:
``stochastic_binarize`` (one key, and many keys in one pass against
``jax.vmap``), the batched uniform draw against ``jax.vmap`` of
``jax.random.uniform``, ``probit_plus_from_updates`` against the jitted
reference (every array passed as an argument; a batch of keys against one
jitted call a key: ``jax.vmap`` of the jitted function moves an estimate by
an ulp against its own single calls), ``probit_plus_aggregate``,
``codes_to_counts``, ``byte_popcount``, ``flip_codes``,
``signsgd_mv_aggregate``, ``rsa_aggregate`` and the pipeline's call for
PRoBit+ (with and without error feedback), signSGD-MV and RSA, with
``flip_n`` and ``flip_gate``.

Then the reference's ``tests/test_theorems.py``,
``tests/test_bitflip_robustness.py`` and ``tests/test_properties.py`` on
the port's API, with their sizes, seeds and bars. The repetitions that the
reference vmaps are one batched draw here. The bit-flip pipelines use
``chunk=D``: with ``D`` no larger than a chunk only chunk 0 is drawn, whose
first ``D`` uniforms are the default chunk's, so the estimates are the
default pipeline's bit for bit at 1/64 of the draws.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # optional dep; see tests/_hypothesis_fallback.py
    from _hypothesis_fallback import given, settings, st

import repro  # noqa: E402,F401
import repro.core as rc  # noqa: E402
import repro.core.quantizer as rq  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DPConfig,
    build_pipeline,
    byte_popcount,
    codes_to_counts,
    dp_b_floor,
    flip_codes,
    flip_wire,
    ml_estimate_from_counts,
    packed_counts,
    privacy_loss,
    probit_plus_aggregate,
    probit_plus_from_updates,
    rsa_aggregate,
    signsgd_mv_aggregate,
    stochastic_binarize,
)
from repro_torch.core import quantizer  # noqa: E402
from repro_torch.core.aggregation import PackedWire, _unpack_codes  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tkey(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _codes(shape, seed):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, 1, -1).astype(np.int8)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1001,), (3, 37)])
def test_stochastic_binarize_one_key_equals_jax(shape):
    delta, b = _rand(shape, 1, 0.02), np.abs(_rand(shape[-1:], 2, 0.03)) + 0.001
    b[:3] = [0.0, 1e-30, 0.01]  # a dead coordinate, a tiny range, |delta| past b
    want = rc.stochastic_binarize(jax.random.PRNGKey(4), delta, b)
    got = stochastic_binarize(prng.key(4), torch.from_numpy(delta), torch.from_numpy(b))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_stochastic_binarize_many_keys_equals_jax_vmap(monkeypatch):
    """(M, 2) keys draw every client in one pass, as jax.vmap over
    split(key, M); the blocked draw of a long key batch gives the same
    bits."""
    m, d = 7, 1001
    upd, b = _rand((m, d), 3, 0.01), np.full((d,), 0.05, np.float32)
    jkeys = jax.random.split(jax.random.PRNGKey(3), m)
    want = np.asarray(jax.vmap(rc.stochastic_binarize, in_axes=(0, 0, None))(jkeys, upd, b))
    keys = prng.split(prng.key(3), m)
    np.testing.assert_array_equal(want, stochastic_binarize(keys, torch.from_numpy(upd), torch.from_numpy(b)).numpy())
    monkeypatch.setattr(quantizer, "UNIFORM_BLOCK_WORDS", 2 * d)  # two keys a block
    np.testing.assert_array_equal(want, stochastic_binarize(keys, torch.from_numpy(upd), torch.from_numpy(b)).numpy())


def test_batched_uniform_draw_equals_jax_vmap():
    jkeys = jax.random.split(jax.random.PRNGKey(11), 33)
    want = jax.vmap(lambda k: jax.random.uniform(k, (257,)))(jkeys)
    got = prng.uniform(_tkey(jkeys), (257,))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_probit_plus_from_updates_equals_jitted_reference():
    m, d = 7, 1001
    upd, b = _rand((m, d), 5, 0.01), np.full((d,), 0.05, np.float32)
    ref = jax.jit(rc.probit_plus_from_updates)
    got = probit_plus_from_updates(prng.key(3), torch.from_numpy(upd), torch.from_numpy(b))
    np.testing.assert_array_equal(np.asarray(ref(jax.random.PRNGKey(3), upd, b)), got.numpy())
    jkeys = jax.random.split(jax.random.PRNGKey(5), 6)
    want = np.stack([np.asarray(ref(k, upd, b)) for k in jkeys])
    got = probit_plus_from_updates(_tkey(jkeys), torch.from_numpy(upd), torch.from_numpy(b))
    assert got.shape == (6, d)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("m", [1, 8, 13])
def test_counts_and_aggregates_equal_reference(m):
    d = 203
    codes, b = _codes((m, d), m), np.abs(_rand((d,), 7, 0.02)) + 0.001
    codes[:, :5] = np.where(np.arange(m)[:, None] % 2 == 0, 1, -1)  # ties at even M
    tc = torch.from_numpy(codes)
    np.testing.assert_array_equal(np.asarray(rc.codes_to_counts(codes)), codes_to_counts(tc).numpy())
    assert codes_to_counts(tc).dtype == torch.int32
    want = jax.jit(rc.probit_plus_aggregate)(codes, b)
    np.testing.assert_array_equal(np.asarray(want), probit_plus_aggregate(tc, torch.from_numpy(b)).numpy())
    for ref, port in ((rc.signsgd_mv_aggregate, signsgd_mv_aggregate), (rc.rsa_aggregate, rsa_aggregate)):
        for step in (0.01, 0.37):
            want = jax.jit(ref, static_argnums=1)(codes, step)
            np.testing.assert_array_equal(np.asarray(want), port(tc, step).numpy())
    if m % 2 == 0:
        assert (signsgd_mv_aggregate(tc)[:5] == 0).all()


def test_flip_codes_equals_reference_and_copies():
    codes = _codes((9, 31), 2)
    tc = torch.from_numpy(codes.copy())
    got = flip_codes(tc, 4)
    np.testing.assert_array_equal(np.asarray(rc.flip_codes(jnp.asarray(codes), 4)), got.numpy())
    np.testing.assert_array_equal(tc.numpy(), codes)  # the caller's codes are untouched
    assert torch.equal(flip_codes(tc, 0), tc) and flip_codes(tc, 0) is not tc


def test_byte_popcount_equals_reference():
    x = np.concatenate([np.arange(256), np.random.default_rng(1).integers(0, 256, 1000)]).astype(np.uint8)
    got = byte_popcount(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(rq.byte_popcount(jnp.asarray(x))), got.numpy())


PIPE_CASES = {
    "probit_plus": ("probit_plus", {}),
    "probit_plus_ef": ("probit_plus", {"error_feedback": True}),
    "signsgd_mv": ("signsgd_mv", {"agg_step": 0.02}),
    "rsa": ("rsa", {}),
}


@pytest.mark.parametrize("flip_n,flip_gate", [(0, None), (3, None), (3, False)])
@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_pipeline_call_equals_reference(case, flip_n, flip_gate):
    """The whole synchronous step, theta_hat and residuals, bit for bit
    with the jitted reference pipeline; a traced False gate keeps the
    adversary off."""
    name, kw = PIPE_CASES[case]
    m, d = 12, 100
    upd, res = _rand((m, d), 8, 0.02), _rand((m, d), 9, 0.003)
    jpipe, tpipe = rc.build_pipeline(name, **kw), build_pipeline(name, **kw)
    gate = None if flip_gate is None else jnp.asarray(flip_gate)
    want_t, want_r = jax.jit(lambda k, u, b, r, g: jpipe(k, u, b, r, flip_n=flip_n, flip_gate=g))(
        jax.random.PRNGKey(2), upd, jnp.float32(0.04), res, gate)
    got_t, got_r = tpipe(prng.key(2), torch.from_numpy(upd), torch.tensor(0.04), torch.from_numpy(res),
                         flip_n=flip_n, flip_gate=flip_gate)
    np.testing.assert_array_equal(np.asarray(want_t), got_t.numpy())
    np.testing.assert_array_equal(np.asarray(want_r), got_r.numpy())


@pytest.mark.parametrize("name", ["probit_plus", "signsgd_mv"])
def test_pipeline_call_on_a_group_equals_its_elements(name):
    """Keys (E, 2) and updates (E, M, d): each element's estimate is its own
    call's, bit for bit, with the flip gated per element."""
    e, m, d = 3, 10, 50
    upd = torch.from_numpy(_rand((e, m, d), 3, 0.02))
    keys = prng.split(prng.key(9), e)
    gate = np.asarray([True, False, True])
    pipe = build_pipeline(name)
    theta, _ = pipe(keys, upd, torch.full((e,), 0.05), torch.zeros_like(upd), flip_n=4, flip_gate=gate)
    for i in range(e):
        want, _ = pipe(keys[i], upd[i], torch.tensor(0.05), torch.zeros(m, d), flip_n=4 if gate[i] else 0)
        assert torch.equal(theta[i], want), i


# ---------------------------------------------------------------------------
# tests/test_theorems.py on the port
# ---------------------------------------------------------------------------


def _updates(key, m, d, scale=0.01):
    # heterogeneous client means around a common theta (paper Fig. 1 model)
    theta = scale * prng.normal(key, (d,))
    noise = scale * 0.5 * prng.normal(prng.fold_in(key, 1), (m, d))
    return theta + noise


class TestTheorem1:
    def test_unbiased(self):
        """E[theta_hat] == theta over quantization randomness."""
        key = prng.key(0)
        m, d = 32, 64
        upd = _updates(key, m, d)
        b = upd.abs().max() + 0.01
        bvec = torch.full((d,), float(b))
        reps = 600
        keys = prng.split(prng.fold_in(key, 7), reps)
        mean_est = probit_plus_from_updates(keys, upd, bvec).mean(0)
        target = upd.mean(0)  # FedAvg value = theta estimate target
        se = float(b) / np.sqrt(m * reps)
        assert float((mean_est - target).abs().max()) < 6 * se

    def test_error_formula(self):
        """E||theta - theta_hat||^2 == sum(b^2 - theta^2)/M for known theta."""
        key = prng.key(1)
        d, m = 128, 16
        theta = 0.02 * prng.normal(key, (d,))
        b = 0.05
        bvec = torch.full((d,), b)
        # all clients at exactly theta: the only error is quantization
        upd = theta.expand(m, d)
        reps = 800
        errs = ((probit_plus_from_updates(prng.split(key, reps), upd, bvec) - theta) ** 2).sum(-1)
        expected = float(((b**2 - theta**2) / m).sum())
        measured = float(errs.mean())
        assert abs(measured - expected) / expected < 0.1

    def test_error_rate_O_1_over_M(self):
        """Doubling M halves the squared error (Thm 1.3 rate)."""
        key = prng.key(2)
        d = 256
        theta = 0.02 * prng.normal(key, (d,))
        b = torch.full((d,), 0.06)
        errs = {}
        for m in (8, 32, 128):
            upd = theta.expand(m, d)
            keys = prng.split(prng.fold_in(key, m), 300)
            errs[m] = float(((probit_plus_from_updates(keys, upd, b) - theta) ** 2).sum(-1).mean())
        assert errs[32] < errs[8] / 2.5
        assert errs[128] < errs[32] / 2.5


class TestTheorem2:
    @settings(deadline=None, max_examples=10)
    @given(st.integers(0, 2**31 - 1), st.sampled_from([0.1, 0.2, 0.4]))
    def test_byzantine_deviation_bound(self, seed, beta):
        """||E[theta]_R - E[theta]_B|| <= 2 beta ||b|| under ANY bit attack."""
        key = prng.key(seed)
        m, d = 40, 32
        n_byz = int(m * beta)
        upd = _updates(key, m, d)
        bvec = torch.full((d,), float(upd.abs().max()) + 0.01)
        reps = 400
        keys = prng.split(prng.fold_in(key, 3), reps)
        client_keys = prng.split(keys, m).movedim(-2, 0)  # (M, reps, 2)
        codes = stochastic_binarize(client_keys, upd.unsqueeze(1), bvec)
        clean = probit_plus_aggregate(codes, bvec).mean(0)
        attacked = probit_plus_aggregate(flip_codes(codes, n_byz), bvec).mean(0)  # worst-case bit adversary
        dev = float(torch.linalg.norm(clean - attacked))
        bound = 2 * beta * float(torch.linalg.norm(bvec))
        assert dev <= bound * 1.05  # 5% slack for Monte-Carlo noise

    def test_magnitude_immunity(self):
        """A single Byzantine with unbounded magnitude moves PRoBit+ by at
        most 2b/M per coordinate — while FedAvg diverges arbitrarily."""
        key = prng.key(3)
        m, d = 20, 16
        upd = _updates(key, m, d)
        evil = upd.clone()
        evil[0] = 1e9
        bvec = torch.full((d,), float(upd[1:].abs().max()) + 0.01)
        keys = prng.split(key, 500)
        clean = probit_plus_from_updates(keys, upd, bvec).mean(0)
        attacked = probit_plus_from_updates(keys, evil, bvec).mean(0)
        per_coord = (clean - attacked).abs()
        assert float(per_coord.max()) <= 2 * float(bvec[0]) / m * 1.3
        fedavg_dev = (evil.mean(0) - upd.mean(0)).abs().max()
        assert float(fedavg_dev) > 1e6  # FedAvg is destroyed


class TestTheorem3:
    @settings(deadline=None, max_examples=25)
    @given(st.integers(0, 2**31 - 1), st.sampled_from([0.05, 0.1, 0.5, 1.0]))
    def test_privacy_loss_bounded_by_eps(self, seed, eps):
        """Worst-case log-likelihood ratio <= eps when b respects the floor."""
        key = prng.key(seed)
        d = 64
        delta1 = 2e-4
        cfg = DPConfig(eps, delta1)
        delta_a = 0.01 * prng.normal(key, (d,))
        # adjacent update: l1 perturbation of size exactly Delta_1
        v = prng.normal(prng.fold_in(key, 1), (d,))
        v = v / v.abs().sum() * delta1
        delta_b = delta_a + v
        floor = dp_b_floor(torch.maximum(delta_a.abs(), delta_b.abs()).max(), cfg)
        b = torch.full((d,), float(floor))
        assert float(privacy_loss(delta_a, delta_b, b)) <= eps * 1.0001

    def test_privacy_loss_finite_at_range_boundary(self):
        """delta = +-b exactly drives binarize_prob to {0, 1}; the empirical
        loss must clamp, not diverge to inf/NaN."""
        b = torch.full((3,), 0.02)
        pl = privacy_loss(torch.tensor([0.02, -0.02, 0.02]), torch.tensor([-0.02, 0.02, 0.01]), b)
        assert bool(torch.isfinite(pl))
        pl1 = privacy_loss(torch.tensor([0.02]), torch.tensor([0.0]), b[:1])
        assert bool(torch.isfinite(pl1))

    def test_smaller_eps_needs_larger_b(self):
        floors = [float(dp_b_floor(torch.tensor(0.01), DPConfig(e, 2e-4))) for e in (1.0, 0.1, 0.01)]
        assert floors[0] < floors[1] < floors[2]


# ---------------------------------------------------------------------------
# tests/test_bitflip_robustness.py on the port
# ---------------------------------------------------------------------------

M, D = 40, 128
B = 0.05
STEP = 0.01
REPS = 400
KEY = prng.key(0)
BETAS = (0.2, 0.45, 0.6)


@functools.lru_cache(maxsize=None)
def _bitflip_updates():
    """Heterogeneous updates with strong per-coordinate signal |mean| = b/2
    (jax.random.bernoulli(KEY, 0.5) is uniform(KEY) < 0.5)."""
    signs = torch.where(prng.uniform(KEY, (D,)) < 0.5, 1.0, -1.0)
    theta = 0.5 * B * signs
    noise = 0.15 * B * prng.normal(prng.fold_in(KEY, 1), (M, D))
    return theta, theta + noise


def _pipe(name):
    return build_pipeline(name, chunk=D, **({"agg_step": STEP} if name == "signsgd_mv" else {}))


@functools.lru_cache(maxsize=None)
def _mean_estimate(name, beta):
    """E[theta_hat] over the quantizer randomness at flip fraction beta: the
    REPS draws as one group through the pipeline's call."""
    _, upd = _bitflip_updates()
    keys = prng.split(prng.fold_in(KEY, 2), REPS)
    theta, _ = _pipe(name)(keys, upd.expand(REPS, M, D), torch.full((REPS,), B), torch.zeros(REPS, M, D),
                           flip_n=int(M * beta), flip_gate=True)
    return theta.mean(0)


def test_wire_flip_equals_dense_flip_codes():
    """The packed-wire bit inversion is exactly flip_codes on the codes."""
    _, upd = _bitflip_updates()
    n = M // 4
    wire, _ = _pipe("probit_plus").compressor.compress(KEY, upd, torch.tensor(B), torch.zeros(M, D))
    flipped = flip_wire(wire, n)
    assert isinstance(flipped, PackedWire)
    assert torch.equal(_unpack_codes(flipped.packed, D), flip_codes(_unpack_codes(wire.packed, D), n))


def test_probit_degrades_gracefully():
    """Deviation stays on the Theorem-2 line: <= 2 beta b per coordinate,
    ~linear in beta, no discontinuity at the beta = 1/2 threshold."""
    clean = _mean_estimate("probit_plus", 0.0)
    devs = {}
    for beta in BETAS:
        devs[beta] = float((_mean_estimate("probit_plus", beta) - clean).abs().max())
        assert devs[beta] <= 2 * beta * B * 1.05, (beta, devs[beta])
    assert devs[0.2] < devs[0.45] < devs[0.6]
    assert 2.0 <= devs[0.6] / devs[0.2] <= 3.3
    assert devs[0.6] / devs[0.45] <= 1.6  # no phase transition at 1/2


def test_signsgd_mv_breaks_at_majority_threshold():
    """Majority voting hides the attack below 1/2 (zero deviation), then
    reverses every coordinate at full step amplitude above it."""
    theta, _ = _bitflip_updates()
    clean = _mean_estimate("signsgd_mv", 0.0)
    dev_pre = float((_mean_estimate("signsgd_mv", 0.45) - clean).abs().max())
    att = _mean_estimate("signsgd_mv", 0.6)
    dev_post = float((att - clean).abs().max())
    wrong = float((torch.sign(att) != torch.sign(theta)).float().mean())
    assert dev_pre <= 0.1 * STEP, dev_pre
    assert dev_post >= 1.9 * STEP, dev_post
    assert wrong >= 0.95, wrong


def test_probit_outlasts_signsgd():
    """Past the majority threshold signSGD-MV's error is maximal relative to
    its own output range, PRoBit+'s the graceful 2-beta-b fraction."""
    beta = 0.6
    rel = {}
    for name, full_range in (("probit_plus", 2 * B), ("signsgd_mv", 2 * STEP)):
        rel[name] = float((_mean_estimate(name, beta) - _mean_estimate(name, 0.0)).abs().max()) / full_range
    assert rel["signsgd_mv"] >= 0.9
    assert rel["probit_plus"] <= beta * 1.05
    assert rel["probit_plus"] < rel["signsgd_mv"]


# ---------------------------------------------------------------------------
# tests/test_properties.py on the port
# ---------------------------------------------------------------------------


@settings(deadline=None, max_examples=20)
@given(st.integers(0, 2**31 - 1), st.integers(1, 64), st.integers(1, 257))
def test_estimate_bounded_by_b(seed, m, d):
    """|theta_hat_i| <= b_i for every count vector 0..M; the extremes reach
    exactly +/- b."""
    key = prng.key(seed)
    counts = prng.randint(key, (d,), 0, m + 1)
    b = prng.normal(prng.fold_in(key, 1), (d,)).abs() + 1e-3
    theta = ml_estimate_from_counts(counts, m, b)
    assert bool((theta.abs() <= b * (1 + 1e-6)).all())
    np.testing.assert_allclose(ml_estimate_from_counts(torch.full((d,), m), m, b).numpy(), b.numpy(), rtol=1e-6)


@settings(deadline=None, max_examples=20)
@given(st.integers(0, 2**31 - 1), st.integers(2, 64), st.integers(1, 100))
def test_estimate_monotone_in_counts(seed, m, d):
    """Adding a +1 vote to one coordinate raises exactly that estimate."""
    key = prng.key(seed)
    counts = prng.randint(key, (d,), 0, m)  # leave headroom for +1
    b = prng.normal(prng.fold_in(key, 1), (d,)).abs() + 1e-3
    i = int(prng.randint(prng.fold_in(key, 2), (), 0, d))
    theta = ml_estimate_from_counts(counts, m, b)
    up = counts.clone()
    up[i] += 1
    theta_up = ml_estimate_from_counts(up, m, b)
    assert float(theta_up[i]) > float(theta[i])
    mask = torch.arange(d) != i
    assert torch.equal(theta_up[mask], theta[mask])


@settings(deadline=None, max_examples=10)
@given(st.integers(0, 2**31 - 1), st.integers(1, 12), st.sampled_from([1, 3, 8, 13, 64, 131, 256]))
def test_packed_wire_matches_dense_reference(seed, m, d):
    """The pipeline on the packed wire == the dense-codes estimate, any (M,
    d), d including non-multiples of 8."""
    key = prng.key(seed)
    deltas = 0.02 * prng.normal(key, (m, d))
    b = torch.tensor(0.05)
    pipe = build_pipeline("probit_plus", chunk=64)
    wire, _ = pipe.compressor.compress(key, deltas, b, torch.zeros(m, d))
    codes = _unpack_codes(wire.packed, d)
    assert torch.equal(packed_counts(wire.packed)[:d], codes_to_counts(codes))
    theta, _ = pipe(key, deltas, b, torch.zeros(m, d))
    np.testing.assert_allclose(theta.numpy(), probit_plus_aggregate(codes, wire.b).numpy(), rtol=1e-6, atol=1e-8)
