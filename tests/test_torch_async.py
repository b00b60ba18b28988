"""The port's buffered-asynchronous round and weighted estimates against the
JAX package's.

The weighted counts, staleness weights and weighted servers are held to the
reference's functions on the same inputs. The asynchronous round is held
three ways: at a full buffer, zero latency and zero decay it equals the
port's own synchronous round bit for bit (5 aggregators x 5 rounds); fed
the reference round's own uploads, its buffer (rows, ages, valid flags,
owners) equals the reference's exactly and its estimate to float
tolerance; and both FLSimulations run the same straggler config. The
straggler cases of ``tests/test_async_rounds.py`` run on the port.

Tolerances: the weighted estimate multiplies by the f32 reciprocal of the
weight sum (so unit weights give the synchronous estimate bit for bit),
where the reference divides by it (XLA keeps a division by a traced
value), and torch's f32 ``pow`` may differ from XLA's in the last bit at a
fractional decay: estimates are held to rtol 1e-6, weights to 2 ulp.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import build_pipeline as jbuild  # noqa: E402
from repro.core import quantizer as jq  # noqa: E402
from repro.data import make_classification, partition_label_skew  # noqa: E402
from repro.fl import FLConfig as JConfig, FLSimulation as JSim  # noqa: E402
from repro.fl import rounds as jr  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import build_pipeline as tbuild  # noqa: E402
from repro_torch.core import is_timing_attack  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulation  # noqa: E402
from repro_torch.fl import rounds as tr  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

N = 10
AGGREGATORS = ("probit_plus", "fedavg", "fed_gm", "signsgd_mv", "rsa")
COUNT_SCHEMES = ("probit_plus", "signsgd_mv", "rsa")
WEIGHTS = {
    "unit": np.ones(12, np.float32),
    "mask01": np.array([1, 0] * 6, np.float32),
    "staleness": ((1.0 + np.arange(12) % 4) ** -0.5).astype(np.float32),
}
# The weighted estimate against the reference: rtol 1e-6 for the reciprocal
# multiply against its division; atol for a count that sums its fractional
# weights in another order, one ulp off: (2 N - M^w) cancels, so the ulp of
# N ~ 5 (4.8e-7) reaches theta as 2 ulp / M^w * b (b = 0.1) ~ 1.3e-8.
EST_RTOL, EST_ATOL = 1e-6, 2e-8


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _task():
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=1000, n_test=200)
    parts = partition_label_skew(ytr, N, 2, 60, seed=1)
    p0 = jax.tree_util.tree_map(np.asarray, jv.init_mlp(jax.random.PRNGKey(0), hidden=8))
    return p0, np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts]), {"x": xte, "y": yte}


def _cfg(**kw):
    return dict(dict(n_clients=N, rounds=3, local_epochs=1), **kw)


def _ctxs(**kw):
    """The reference's and the port's round contexts of one config."""
    p0, cx, cy, test = _task()
    jctx = jr.make_context(JConfig(**_cfg(**kw)), p0, functools.partial(jv.xent_loss, jv.mlp_logits),
                           functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)
    return jctx, _port_ctx(**kw)


def _port_ctx(**kw):
    p0, cx, cy, test = _task()
    return tr.make_context(FLConfig(**_cfg(**kw)), p0, functools.partial(tv.xent_loss, tv.mlp_logits),
                           functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")


def _port_rounds(ctx, rounds, fn=None):
    """The port's rounds of ``ctx`` from PRNGKey(seed): (state, metrics) of each."""
    params, state, fn = tr.cell_params(ctx.cfg), tr.init_run_state(ctx), fn or tr.round_fn(ctx)
    key, out = prng.key(ctx.cfg.seed), []
    for _ in range(rounds):
        key, kb, kr = prng.split(key, 3)
        state, met = fn(ctx, params, kr, state, tr.round_batches(ctx, kb))
        out.append((state, met))
    return out


# ---------------------------------------------------------------------------
# Weighted counts, staleness weights, weighted servers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(WEIGHTS))
def test_weighted_counts_against_reference(name):
    """packed_weighted_counts at d % 8 != 0 and a chunk that does not divide
    the row: unit and 0/1 weights exactly (and equal to packed_counts for
    unit weights), fractional ones to rtol 1e-6 (f32 sums in another order)."""
    w = WEIGHTS[name]
    packed = np.random.default_rng(3).integers(0, 256, (12, 13), dtype=np.uint8)
    want = np.asarray(jax.jit(functools.partial(jq.packed_weighted_counts, chunk=16))(packed, w))
    got = tq.packed_weighted_counts(_t(packed), _t(w))
    assert got.dtype == torch.float32 and got.shape == (8 * 13,)
    if name == "staleness":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    if name == "unit":
        np.testing.assert_array_equal(got.numpy(), tq.packed_counts(_t(packed)).float().numpy())


def test_weighted_counts_walk_blocks(monkeypatch):
    """Blocks of bytes (here 7 blocks of 2 bytes) give the counts of one
    block, with integer weights (whose f32 sums are exact in any order;
    torch's order of a fractional sum may depend on the block's width)."""
    rng = np.random.default_rng(4)
    packed = _t(rng.integers(0, 256, (12, 13), dtype=np.uint8))
    w = _t(rng.integers(0, 4, 12).astype(np.float32))
    whole = tq.packed_weighted_counts(packed, w)
    monkeypatch.setattr(tq, "WEIGHTED_BLOCK_WORDS", 8 * 12 * 2)
    assert torch.equal(tq.packed_weighted_counts(packed, w), whole)


@pytest.mark.parametrize("decay", [0.0, 0.5, 0.3, 1.0, 2.0])
def test_staleness_weights_against_reference(decay):
    """(1 + age) ** -decay, zero on invalid slots: exact at integer decays,
    within 2 ulp (torch's and XLA's f32 pow) at fractional ones; all ones at
    decay 0."""
    ages = np.arange(40, dtype=np.int32)
    valid = np.arange(40) % 3 != 0
    want = np.asarray(jax.jit(lambda a, v: jagg.staleness_weights(a, decay, v))(ages, valid))
    got = tagg.staleness_weights(_t(ages), decay, _t(valid)).numpy()
    if decay == int(decay):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    assert (got[~valid] == 0).all()
    if decay == 0.0:
        assert (tagg.staleness_weights(_t(ages), decay).numpy() == 1.0).all()


@pytest.mark.parametrize("name", ["fedavg", "fed_gm"])
def test_weighted_dense_servers_against_reference(name):
    """Weighted FedAvg and Fed-GM: unit weights give the unweighted port
    result bit for bit; staleness weights agree with the jitted reference
    to rtol 1e-5 (sums and Weiszfeld steps in another order); all-zero
    weights give zero (FedAvg)."""
    rng = np.random.default_rng(5)
    u = (0.05 * rng.standard_normal((12, 50))).astype(np.float32)
    w = WEIGHTS["staleness"].copy()
    w[3] = 0.0
    jfn = jagg.fedavg_aggregate if name == "fedavg" else functools.partial(jagg.geometric_median, iters=16)
    tfn = tagg.fedavg_aggregate if name == "fedavg" else functools.partial(tagg.geometric_median, iters=16)
    want = np.asarray(jax.jit(lambda u, w: jfn(u, weights=w))(u, w))
    np.testing.assert_allclose(tfn(_t(u), weights=_t(w)).numpy(), want, rtol=1e-5, atol=1e-9)
    assert torch.equal(tfn(_t(u), weights=torch.ones(12)), tfn(_t(u)))
    if name == "fedavg":
        assert not tfn(_t(u), weights=torch.zeros(12)).any()


def _wires(name):
    """The same cohort compressed by both packages (d = 13, chunk 16)."""
    rng = np.random.default_rng(6)
    deltas = (0.05 * rng.standard_normal((12, 13))).astype(np.float32)
    jpipe, tpipe = jbuild(name, chunk=16), tbuild(name, chunk=16)
    jwire, _ = jpipe.compress_wire(jax.random.PRNGKey(7), deltas, jnp.float32(0.1), jnp.zeros((12, 13)))
    twire, _ = tpipe.compress_wire(prng.key(7), _t(deltas), torch.tensor(0.1), torch.zeros(12, 13))
    np.testing.assert_array_equal(np.asarray(jwire.packed), twire.packed.numpy())
    return jpipe, jwire, tpipe, twire


@pytest.mark.parametrize("name", COUNT_SCHEMES)
@pytest.mark.parametrize("wname", ["unit", "staleness"])
def test_weighted_count_estimates_against_reference(name, wname):
    """The weighted estimate of each count scheme against the jitted
    reference (EST_RTOL, EST_ATOL); with unit weights it is the port's
    unweighted estimate bit for bit."""
    jpipe, jwire, tpipe, twire = _wires(name)
    w = WEIGHTS[wname]
    want = np.asarray(jax.jit(jpipe.estimate)(jwire, w))
    got = tpipe.estimate(twire, weights=_t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=EST_RTOL, atol=EST_ATOL)
    if wname == "unit":
        assert torch.equal(got, tpipe.estimate(twire))


def test_weighted_estimate_of_no_weight_is_zero():
    _, _, tpipe, twire = _wires("probit_plus")
    assert not tpipe.estimate(twire, weights=torch.zeros(12)).any()


# ---------------------------------------------------------------------------
# The asynchronous round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_async_zero_latency_equals_sync(aggregator):
    """A full buffer, zero latency and zero decay: every state field and
    metric of 5 rounds equal the port's fl_round bit for bit, the buffer
    full and fresh in every round."""
    sync = _port_rounds(_port_ctx(aggregator=aggregator), 5, tr.fl_round)
    asyn = _port_rounds(_port_ctx(aggregator=aggregator, async_buffer=N), 5)
    for (ss, ms), (sa, ma) in zip(sync, asyn):
        assert isinstance(sa, tr.AsyncRoundState)
        for f in ("w_global", "w_locals", "residuals"):
            assert torch.equal(getattr(ss, f), getattr(sa, f)), f
        assert ss.b.b.item() == sa.b.b.item() and ss.b.prev_vote.item() == sa.b.prev_vote.item()
        for k in ("loss", "b", "theta_mse", "theta"):
            assert torch.equal(ms[k], ma[k]), k
        assert ma["buf_fill"].item() == 1.0 and ma["mean_age"].item() == 0.0


def test_async_round_against_reference_with_straggler_alie(monkeypatch):
    """B = 5 < M = 10, latency 3, decay 0.5, straggler+alie: each round of
    the reference (op by op) and the port is fed the reference round's own
    client uploads, so the arrival draw, straggler gate, slot fold and
    estimate meet the same wire. Buffer rows, ages, valid flags and owners
    exact; the staleness weights to 2 ulp and theta_hat to EST_RTOL and
    EST_ATOL; b exact; the loss, buf_fill and mean_age to 1 ulp."""
    kw = dict(async_buffer=5, async_latency=3.0, staleness_decay=0.5, byz_frac=0.2, attack="straggler+alie")
    jctx, tctx = _ctxs(**kw)
    jp, tp = jr.cell_params(jctx.cfg), tr.cell_params(tctx.cfg)
    assert jp.straggler_gate and is_timing_attack(tctx.cfg.attack)
    uploads = jax.jit(lambda k, s, b: jr._client_uploads(jctx, jp, k, s, b))
    seen = {}
    for pkg, pipe in (("jax", jctx.pipeline), ("torch", tctx.pipeline)):
        def estimate(self, wire, weights=None, _pkg=pkg, _orig=type(pipe).estimate):
            seen[_pkg] = (np.array(weights), _orig(self, wire, weights))
            return seen[_pkg][1]

        monkeypatch.setattr(type(pipe), "estimate", estimate)
    jstate, tstate = jr.init_run_state(jctx), tr.init_run_state(tctx)
    jkey, tkey = jax.random.PRNGKey(0), prng.key(0)
    fills, ages = set(), set()
    for t in range(5):
        jkey, jkb, jkr = jax.random.split(jkey, 3)
        tkey, _, tkr = prng.split(tkey, 3)
        up = uploads(jkr, jstate, jr.round_batches(jctx, jkb))
        t_up = (None, *(_t(x) for x in up[1:5]),
                tagg.PackedWire(packed=_t(up[5].packed), b=_t(up[5].b), d=up[5].d), _t(up[6]))
        monkeypatch.setattr(jr, "_client_uploads", lambda *a: up)
        monkeypatch.setattr(tr, "_client_uploads", lambda *a: t_up)
        jstate, jm = jr.async_fl_round(jctx, jp, jkr, jstate, None)
        tstate, tm = tr.async_fl_round(tctx, tp, tkr, tstate, None)
        for f in ("buf_rows", "buf_age", "buf_valid", "buf_owner"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f"{f} {t}")
        np.testing.assert_allclose(seen["torch"][0], seen["jax"][0], rtol=2.4e-7, atol=0)
        np.testing.assert_allclose(seen["torch"][1].numpy(), np.asarray(seen["jax"][1]), rtol=EST_RTOL, atol=EST_ATOL)
        assert tm["b"].item() == float(jm["b"])
        for k in ("loss", "buf_fill", "mean_age"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1.2e-7)
        fills.add(tm["buf_fill"].item())
        ages.add(tm["mean_age"].item())
    assert min(fills) < 1.0 and max(ages) > 0.0  # the buffer held stale and empty slots


def test_async_simulation_against_reference():
    """Both FLSimulations (the reference's jitted) with straggler+sign_flip
    at B = 5, latency 1 and decay 0.5 for 3 rounds: b exact in every round,
    the loss to rtol 1e-4 (the deltas differ in the last bits, see
    tests/test_torch_round.py), buf_fill and mean_age to 1 ulp."""
    kw = _cfg(async_buffer=5, async_latency=1.0, staleness_decay=0.5, byz_frac=0.2, attack="straggler+sign_flip")
    p0, cx, cy, test = _task()
    js = JSim(JConfig(**kw), p0, functools.partial(jv.xent_loss, jv.mlp_logits),
              functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)
    ts = FLSimulation(FLConfig(**kw), p0, functools.partial(tv.xent_loss, tv.mlp_logits),
                      functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")
    assert isinstance(ts.state, tr.AsyncRoundState)
    key = jax.random.PRNGKey(0)
    for _, tm in ts.iter_rounds():
        key, kb, kr = jax.random.split(key, 3)
        js.state, jm = js._round(kr, js.state, js._round_batches(kb))
        assert tm["b"].item() == float(jm["b"])
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        for k in ("buf_fill", "mean_age"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1.2e-7)
        np.testing.assert_array_equal(ts.state.buf_owner.numpy(), np.asarray(js.state.buf_owner))
        np.testing.assert_array_equal(ts.state.buf_age.numpy(), np.asarray(js.state.buf_age))


def test_empty_buffer_estimates_zero():
    """Nothing arrives under extreme latency: every slot stays invalid, the
    estimate is zero and the global model does not move."""
    ctx = _port_ctx(async_buffer=N, async_latency=1e9)
    for state, met in _port_rounds(ctx, 2):
        assert met["buf_fill"].item() == 0.0 and not met["theta"].any()
        assert torch.equal(state.w_global, ctx.w0)
    assert not state.buf_valid.any()


def test_straggler_delivers_once_then_withholds():
    """The straggler fills its slot in round 0 and never refreshes it: its
    upload ages a round a round while, under extreme honest latency, the
    honest slots stay empty."""
    n_byz = 2
    ctx = _port_ctx(byz_frac=0.2, attack="straggler+sign_flip", async_buffer=N, async_latency=1e9)
    for t, (state, met) in enumerate(_port_rounds(ctx, 4)):
        assert state.buf_valid[:n_byz].all() and not state.buf_valid[n_byz:].any()
        assert (state.buf_age[:n_byz] == t).all()
        assert met["buf_fill"].item() == pytest.approx(n_byz / N)
        assert met["mean_age"].item() == t


def test_buffer_contention_smaller_than_cohort():
    """B < M at zero latency: every slot is overwritten by its
    highest-index sharer each round (ages stay 0)."""
    ctx = _port_ctx(async_buffer=3)
    for state, met in _port_rounds(ctx, 3):
        assert met["buf_fill"].item() == 1.0 and met["mean_age"].item() == 0.0
        assert state.buf_owner.tolist() == [9, 7, 8]
    assert state.buf_rows.shape[0] == 3


def test_straggler_repoisons_contended_slot():
    """Under slot contention an honest sharer can evict the withheld
    Byzantine upload; the straggler then re-delivers. Over 8 rounds both
    happen: a Byzantine owning its slot, and the honest sharer owning it."""
    n_byz = 2
    ctx = _port_ctx(byz_frac=0.2, attack="straggler+sign_flip", async_buffer=5, async_latency=1.0)
    byz_owned = honest_owned = 0
    for state, _ in _port_rounds(ctx, 8):
        owner = state.buf_owner[:n_byz]
        byz_owned += int(((owner >= 0) & (owner < n_byz)).any())
        honest_owned += int((owner >= n_byz).any())
    assert byz_owned > 0, "the straggler never re-poisoned its slot"
    assert honest_owned > 0, "the honest sharer never evicted the straggler"


def test_colluding_stragglers_share_slot_without_evicting_each_other():
    """Byzantines 0 and 2 share slot 0 (B = 2): the first delivery sticks
    and ages as a lone straggler's would; ownership never churns."""
    ctx = _port_ctx(byz_frac=0.3, attack="straggler+sign_flip", async_buffer=2, async_latency=1e9)
    owners = []
    for t, (state, _) in enumerate(_port_rounds(ctx, 5)):
        owners.append(state.buf_owner.clone())
        assert (state.buf_age == t).all()
    assert all(torch.equal(o, owners[0]) for o in owners)
    assert all(0 <= o < 3 for o in owners[0].tolist())


# ---------------------------------------------------------------------------
# Config validation
# ---------------------------------------------------------------------------

OK = dict(n_clients=4, rounds=1)
REJECT = [
    (dict(async_buffer=-1), "async_buffer"),
    (dict(async_buffer=5), "exceeds the cohort"),
    (dict(async_buffer=4, async_latency=-0.5), "async_latency"),
    (dict(async_buffer=4, staleness_decay=-1.0), "staleness_decay"),
    (dict(async_latency=1.0), "require buffered-async"),
    (dict(staleness_decay=0.5), "require buffered-async"),
    (dict(attack="straggler"), "timing attack"),
    (dict(attack="straggler+alie"), "timing attack"),
    (dict(attack="straggler+nope", async_buffer=4), "unknown straggler payload"),
    (dict(attack="straggler+none", async_buffer=4), "straggler"),
    (dict(async_buffer=4, topk_frac=0.1), "SparseWire"),
    (dict(async_buffer=2, participation=0.5), "participation == 1.0"),
    (dict(async_buffer=4, client_chunk=2), "cannot stream"),
    (dict(client_chunk=-1), "client_chunk"),
    (dict(client_chunk=2, b_mode="oracle"), "oracle"),
    (dict(client_chunk=2, byz_frac=0.5, attack="alie"), "colludes"),
    (dict(stateless_clients=True), "requires client_chunk"),
    (dict(client_chunk=2, stateless_clients=True, error_feedback=True), "stateless_clients"),
]
ACCEPT = [
    dict(attack="straggler", async_buffer=4),
    dict(attack="straggler+bit_flip", async_buffer=2, byz_frac=0.25),
    dict(async_buffer=4, async_latency=0.5, staleness_decay=0.5),
    dict(client_chunk=3, stateless_clients=True),
    dict(client_chunk=2, byz_frac=0.5, attack="gaussian"),
    dict(client_chunk=2, byz_frac=0.5, attack="bit_flip", participation=0.5),
]


@pytest.mark.parametrize("kw,match", REJECT, ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items())
                         if isinstance(v, dict) else None)
def test_config_rejections_match_reference(kw, match):
    """What the reference's FLConfig rejects, the port rejects with a
    ValueError of the same message."""
    with pytest.raises(ValueError, match=match):
        JConfig(**OK, **kw)
    with pytest.raises(ValueError, match=match):
        FLConfig(**OK, **kw)


@pytest.mark.parametrize("kw", ACCEPT, ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items()))
def test_config_acceptances_match_reference(kw):
    """Valid asynchronous and streaming compositions construct in both."""
    jcfg, cfg = JConfig(**OK, **kw), FLConfig(**OK, **kw)
    assert is_timing_attack(cfg.attack) == bool(jr.cell_params(jcfg).straggler_gate)
