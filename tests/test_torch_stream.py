"""The port's streaming round (clients in chunks of ``client_chunk``)
against its own dense round and against the JAX package's.

The count protocol (init, accumulate, finalize) over any split of the
cohort equals the one-shot estimate. The streamed round equals the dense
round exactly for the count schemes (PRoBit+, signSGD-MV, RSA): global and
personal models, b and residuals, at a chunk that does not divide the
cohort (the weighted pad path), under partial participation, error
feedback, sign_flip, bit_flip and the kernel wire on the ref engine.
FedAvg and Fed-GM sum in another order and are held to 1e-6, the bar of
``tests/test_streaming.py``. The gaussian payload draws a row at a time:
any chunking gives the same noise, equal to the jitted reference's. Against
the reference's eager ``stream_fl_round`` the trajectories are held as the
dense rounds are in ``tests/test_torch_round.py``.
"""

import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import attacks as jatt  # noqa: E402
from repro.data import make_classification, partition_label_skew  # noqa: E402
from repro.fl import FLConfig as JConfig  # noqa: E402
from repro.fl import rounds as jr  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import ATTACK_IDS, apply_attack_stream, build_pipeline  # noqa: E402
from repro_torch.fl import FLConfig  # noqa: E402
from repro_torch.fl import rounds as tr  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

N = 10
AGGREGATORS = ("probit_plus", "signsgd_mv", "rsa", "fedavg", "fed_gm")
COUNT_SCHEMES = ("probit_plus", "signsgd_mv", "rsa")
PLANES = ("w_global", "w_locals", "residuals")


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _task():
    (xtr, ytr), (xte, yte) = make_classification(0, n_train=1000, n_test=200)
    parts = partition_label_skew(ytr, N, 2, 60, seed=1)
    p0 = jax.tree_util.tree_map(np.asarray, jv.init_mlp(jax.random.PRNGKey(0), hidden=8))
    return p0, np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts]), {"x": xte, "y": yte}


def _cfg(**kw):
    return dict(dict(n_clients=N, rounds=2, local_epochs=1), **kw)


def _ctx(**kw):
    p0, cx, cy, test = _task()
    return tr.make_context(FLConfig(**_cfg(**kw)), p0, functools.partial(tv.xent_loss, tv.mlp_logits),
                           functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")


def _run(rounds=2, **kw):
    """The port's rounds of one config from PRNGKey(seed): the final state
    and every round's metrics."""
    ctx = _ctx(**kw)
    params, state, fn = tr.cell_params(ctx.cfg), tr.init_run_state(ctx), tr.round_fn(ctx)
    key, mets = prng.key(ctx.cfg.seed), []
    for _ in range(rounds):
        key, kb, kr = prng.split(key, 3)
        state, met = fn(ctx, params, kr, state, tr.round_batches(ctx, kb))
        mets.append(met)
    return state, mets


# ---------------------------------------------------------------------------
# The count protocol
# ---------------------------------------------------------------------------


def _wire(name, m=12, d=13):
    pipe = build_pipeline(name, chunk=16)
    gen = torch.Generator().manual_seed(0)
    deltas = 0.05 * torch.randn(m, d, generator=gen)
    wire, _ = pipe.compress_wire(prng.key(1), deltas, torch.tensor(0.1), torch.zeros(m, d))
    return pipe, wire


@pytest.mark.parametrize("name", COUNT_SCHEMES)
def test_accumulate_finalize_matches_one_shot(name):
    """Counts accumulated over any split of the cohort give the one-shot
    estimate exactly."""
    pipe, wire = _wire(name)
    one_shot = pipe.server.aggregate(wire)
    for splits in ((4, 4, 4), (5, 4, 3), (12,), (1,) * 12):
        counts, row = pipe.server.init_counts(wire.packed.shape[1]), 0
        for c in splits:
            counts = pipe.server.accumulate_counts(counts, wire.packed[row:row + c])
            row += c
        assert counts.dtype == torch.int32
        assert torch.equal(pipe.server.finalize(counts, wire.n_clients, wire.b), one_shot)


@pytest.mark.parametrize("name", COUNT_SCHEMES)
@pytest.mark.parametrize("wname", ["mask01", "staleness"])
def test_weighted_accumulate_matches_one_shot(name, wname):
    """Weighted counts over a split that does not divide the cohort: 0/1
    weights give the one-shot weighted estimate exactly, fractional ones to
    rtol 1e-6 (f32 sums in another order)."""
    pipe, wire = _wire(name)
    w = torch.tensor([1.0, 0.0] * 6) if wname == "mask01" else (1.0 + torch.arange(12.0) % 4) ** -0.5
    one_shot = pipe.server.aggregate(wire, w)
    counts = pipe.server.init_counts(wire.packed.shape[1], weighted=True)
    for row in range(0, 12, 5):
        counts = pipe.server.accumulate_counts(counts, wire.packed[row:row + 5], w[row:row + 5])
    est = pipe.server.finalize(counts, w.sum(), wire.b)
    if wname == "mask01":
        assert torch.equal(est, one_shot)
    else:
        np.testing.assert_allclose(est.numpy(), one_shot.numpy(), rtol=1e-6, atol=2e-8)


def test_fedavg_stream_sum_matches_dense():
    """FedAvg's running weighted sum against its one-shot weighted mean."""
    pipe, wire = _wire("fedavg")
    w = (torch.arange(12) % 3).float()
    carry = pipe.server.init_stream_sum(wire.updates.shape[1])
    for row in range(0, 12, 5):
        carry = pipe.server.accumulate_sum(carry, wire.updates[row:row + 5], w[row:row + 5])
    np.testing.assert_allclose(pipe.server.finalize_sum(carry).numpy(), pipe.server.aggregate(wire, w).numpy(),
                               rtol=1e-6, atol=1e-9)
    assert not pipe.server.finalize_sum(pipe.server.init_stream_sum(13)).any()


def test_stream_kinds():
    assert [build_pipeline(a).server.stream_kind for a in AGGREGATORS] == ["counts"] * 3 + ["sum", "buffer"]


# ---------------------------------------------------------------------------
# The streamed round against the dense round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("agg", AGGREGATORS)
def test_round_parity_all_aggregators(agg):
    """Chunks of 4 (not dividing M = 10) against the dense round over two
    rounds: the count schemes exactly (every plane, b, the loss within an
    ulp: its sum runs chunk by chunk), FedAvg and Fed-GM to 1e-6; theta_mse
    to rtol 1e-5 (FedAvg's dense theta is the delta mean exactly, its
    streamed one within 1e-11)."""
    dense, dm = _run(aggregator=agg)
    stream, sm = _run(aggregator=agg, client_chunk=4)
    if agg in COUNT_SCHEMES:
        for f in PLANES:
            assert torch.equal(getattr(dense, f), getattr(stream, f)), f
        assert dense.b.b.item() == stream.b.b.item()
    else:
        for f in PLANES:
            np.testing.assert_allclose(getattr(stream, f).numpy(), getattr(dense, f).numpy(), rtol=0, atol=1e-6)
    for a, b in zip(dm, sm):
        np.testing.assert_allclose(b["loss"].item(), a["loss"].item(), rtol=2.4e-7)
        np.testing.assert_allclose(b["theta_mse"].item(), a["theta_mse"].item(), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("extra", [
    dict(participation=0.7),
    dict(error_feedback=True),
    dict(byz_frac=0.2, attack="sign_flip"),
    dict(byz_frac=0.5, attack="bit_flip"),
    dict(use_kernels=True, error_feedback=True),
], ids=["participation", "error_feedback", "sign_flip", "bit_flip", "kernel_wire"])
def test_round_parity_masks_state_attacks(extra):
    """PRoBit+ in chunks of 4: every plane equals the dense round's, with a
    resampled cohort, error feedback (the residuals written back), the
    Byzantine boundary inside a chunk (5 bit_flip rows) and the kernel
    wire (its plain version on the CPU)."""
    dense, _ = _run(**extra)
    stream, _ = _run(client_chunk=4, **extra)
    for f in PLANES:
        assert torch.equal(getattr(dense, f), getattr(stream, f)), f


def test_pad_rows_are_dropped_and_the_state_is_untouched():
    """The last chunk's pad rows wrap onto clients 0 and 1 and train from
    their new models; nothing of them is written back, and the round leaves
    the state it was given as it was (the write-back goes into a copy)."""
    ctx = _ctx(client_chunk=4, error_feedback=True)
    state = tr.init_run_state(ctx)
    before = {f: getattr(state, f).clone() for f in PLANES}
    key = prng.key(3)
    new, _ = tr.stream_fl_round(ctx, tr.cell_params(ctx.cfg), key, state, tr.round_batches(ctx, prng.key(4)))
    for f in PLANES:
        assert torch.equal(getattr(state, f), before[f]), f
    dctx = _ctx(error_feedback=True)
    dense, _ = tr.fl_round(dctx, tr.cell_params(dctx.cfg), key, tr.init_run_state(dctx),
                           tr.round_batches(dctx, prng.key(4)))
    for f in ("w_locals", "residuals"):
        assert torch.equal(getattr(new, f)[:2], getattr(dense, f)[:2]), f
        assert not torch.equal(getattr(new, f)[:2], before[f][:2]), f


@pytest.mark.parametrize("agg", ["probit_plus", "fedavg"])
def test_stateless_rounds(agg):
    """Stateless clients train from the global model and keep one broadcast
    row, which no round changes; the rounds do not depend on the chunking
    (exactly for PRoBit+, to 1e-6 for FedAvg), whole chunks or not."""
    runs = [_run(3, aggregator=agg, client_chunk=c, stateless_clients=True) for c in (4, 5, 10)]
    ctx = _ctx(client_chunk=4, stateless_clients=True)
    for state, mets in runs:
        assert state.w_locals.shape == state.residuals.shape == (1, ctx.d)
        assert torch.equal(state.w_locals[0], ctx.w0) and not state.residuals.any()
        assert all(np.isfinite(m["loss"].item()) for m in mets)
    for state, _ in runs[1:]:
        if agg == "probit_plus":
            assert torch.equal(state.w_global, runs[0][0].w_global)
        else:
            np.testing.assert_allclose(state.w_global.numpy(), runs[0][0].w_global.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The gaussian payload
# ---------------------------------------------------------------------------


def test_gaussian_payload_chunk_invariant():
    """Noise drawn a row at a time: chunks of 4 and of 7 give the same
    rounds."""
    kw = dict(byz_frac=0.2, attack="gaussian")
    s4, _ = _run(client_chunk=4, **kw)
    s7, _ = _run(client_chunk=7, **kw)
    for f in PLANES:
        assert torch.equal(getattr(s4, f), getattr(s7, f)), f


@pytest.mark.parametrize("row0,n_byz", [(0, 2), (2, 5), (4, 3), (0, 9)])
def test_gaussian_stream_draw_against_reference(row0, n_byz):
    """apply_attack_stream on a chunk of 4 rows at cohort positions row0..:
    the Byzantine rows' noise equals the jitted reference's bit for bit,
    the other rows are untouched; sign_flip likewise."""
    d = 3001
    u = np.random.default_rng(row0).standard_normal((4, d)).astype(np.float32)
    rows = np.arange(row0, row0 + 4)
    for name in ("gaussian", "sign_flip", "alie"):
        idx = ATTACK_IDS.index(name)
        want = np.asarray(jax.jit(lambda k, u: jatt.apply_attack_stream(
            idx, k, u, jnp.asarray(rows < n_byz), jnp.asarray(rows)))(jax.random.PRNGKey(5), u))
        got = apply_attack_stream(idx, prng.key(5), _t(u), n_byz, row0)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


# ---------------------------------------------------------------------------
# Against the reference's streaming round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(byz_frac=0.2, attack="sign_flip", participation=0.9),
    dict(aggregator="fedavg", stateless_clients=True, byz_frac=0.2, attack="gaussian"),
], ids=["probit_plus-sign_flip-participation", "fedavg-stateless-gaussian"])
def test_stream_round_against_reference(kw):
    """Two streamed rounds (chunks of 4) of both packages, the reference's
    eager (bit-identical to its dense round): b exact; the loss to rtol
    1e-4; every coordinate of w_global within 1e-5 or off by exactly one
    flipped wire bit, 2b/M at a round's b (the bar and the reasons of
    tests/test_torch_round.py::test_flsimulation_end_to_end)."""
    cfg = _cfg(client_chunk=4, **kw)
    p0, cx, cy, test = _task()
    jctx = jr.make_context(JConfig(**cfg), p0, functools.partial(jv.xent_loss, jv.mlp_logits),
                           functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)
    jstate, jparams, jkey = jr.init_run_state(jctx), jr.cell_params(jctx.cfg), jax.random.PRNGKey(0)
    jm = []
    with jax.disable_jit():
        for _ in range(2):
            jkey, kb, kr = jax.random.split(jkey, 3)
            jstate, m = jr.stream_fl_round(jctx, jparams, kr, jstate, jr.round_batches(jctx, kb))
            jm.append({k: float(v) for k, v in m.items()})
    tstate, tm = _run(**{k: v for k, v in cfg.items() if k not in ("n_clients", "rounds", "local_epochs")})
    assert [m["b"].item() for m in tm] == [m["b"] for m in jm]
    np.testing.assert_allclose([m["loss"].item() for m in tm], [m["loss"] for m in jm], rtol=1e-4)
    diff = np.abs(np.asarray(jstate.w_global) - tstate.w_global.numpy())
    bad = diff > 1e-5
    assert bad.sum() <= 0.001 * diff.size
    n = JConfig(**cfg).n_active
    flips = np.array([2 * b / n for b in [0.01] + [m["b"] for m in jm]])
    for v in diff[bad]:
        assert np.min(np.abs(v - flips)) <= 1e-6, v


def test_stream_shard_raises_naming_a14():
    """stream_shard is ported: the reference's stream_shard checks raise its
    ValueErrors word for word, and without a process group the round warns
    the reference's one-device no-op (as the reference's context does) and
    equals the unsharded streamed round bit for bit
    (tests/test_torch_shard.py runs it over ranks)."""
    for kw in (dict(stream_shard=True), dict(stream_shard=True, client_chunk=2),
               dict(stream_shard=True, client_chunk=2, stateless_clients=True, participation=0.5),
               dict(stream_shard=True, client_chunk=2, stateless_clients=True, aggregator="fed_gm")):
        with pytest.raises(ValueError) as want:
            JConfig(n_clients=N, **kw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            FLConfig(n_clients=N, **kw)
    one_device = "stream_shard is a no-op: only one local device is visible"
    p0, cx, cy, test = _task()
    with pytest.warns(RuntimeWarning, match=one_device):
        jr.make_context(JConfig(**_cfg(client_chunk=4, stateless_clients=True, stream_shard=True)), p0,
                        functools.partial(jv.xent_loss, jv.mlp_logits), functools.partial(jv.accuracy, jv.mlp_logits),
                        cx, cy, test)
    with pytest.warns(RuntimeWarning, match=one_device):
        sharded, sm = _run(client_chunk=4, stateless_clients=True, stream_shard=True)
    plain, pm = _run(client_chunk=4, stateless_clients=True)
    assert torch.equal(sharded.w_global, plain.w_global)
    for a, c in zip(sm, pm):
        assert set(a) == set(c) and all(torch.equal(a[k], c[k]) for k in a)
