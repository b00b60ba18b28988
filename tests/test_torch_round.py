"""One synchronous round of the port against the JAX package's.

Stage test: the JAX round's own deltas go through the port's compressor,
estimate and epilogue, so wire, theta_hat and b can be held exact. End to
end: both FLSimulations on the same config, data and weights, for PRoBit+
and its baselines, every attack, oracle b and partial participation, on
the MLP. PRoBit+ on a tiny CNN and a tiny ResNet, and the grid of every
aggregator, attack, b mode and participation, are in
``tests/test_torch_round_grid.py``, which shares this file's task.
"""

import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402,F401
from repro.data import make_classification, make_image_classification, partition_label_skew  # noqa: E402
from repro.fl import FLConfig as JConfig, FLSimulation as JSim  # noqa: E402
from repro.fl import rounds as jr  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import ACCOUNTANTS  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulation  # noqa: E402
from repro_torch.fl import rounds as tr  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402

N_CLIENTS, PER_CLIENT, HIDDEN = 6, 20, 16
TINY_BLOCKS = (1, 1, 1, 1)
# model: (reference logits, port logits); the tiny CNN on 8x8x1 images,
# the tiny ResNet (width 8, one block a stage) on 16x16x3
LOGITS = {
    "mlp": (jv.mlp_logits, tv.mlp_logits),
    "cnn": (jv.cnn_logits, tv.cnn_logits),
    "resnet": (functools.partial(jv.resnet_logits, blocks=TINY_BLOCKS),
               functools.partial(tv.resnet_logits, blocks=TINY_BLOCKS)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: with several test
    workers on a few cores, torch's thread pool waits far longer than it
    works."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _task(n_clients=N_CLIENTS, model="mlp"):
    key = jax.random.PRNGKey(0)
    if model == "mlp":
        (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=100)
        p0 = jv.init_mlp(key, hidden=HIDDEN)
    elif model == "cnn":
        (xtr, ytr), (xte, yte) = make_image_classification(0, img=8, n_train=600, n_test=100)
        p0 = jv.init_cnn(key, width=4, img=8)
    else:
        (xtr, ytr), (xte, yte) = make_image_classification(0, img=16, channels=3, n_train=600, n_test=100)
        p0 = jv.init_resnet(key, width=8, blocks=TINY_BLOCKS)
    parts = partition_label_skew(ytr, n_clients, 2, PER_CLIENT, seed=1)
    cx = np.stack([xtr[i] for i in parts])
    cy = np.stack([ytr[i] for i in parts])
    return jax.tree_util.tree_map(np.asarray, p0), cx, cy, {"x": xte, "y": yte}


def _sims(model="mlp", **kw):
    p0, cx, cy, test = _task(kw.get("n_clients", N_CLIENTS), model)
    jlogits, tlogits = LOGITS[model]
    base = dict(n_clients=N_CLIENTS, rounds=3, local_epochs=2, use_kernels=True)
    base.update(kw)
    js = JSim(JConfig(**base), p0, functools.partial(jv.xent_loss, jlogits),
              functools.partial(jv.accuracy, jlogits), cx, cy, test)
    ts = FLSimulation(FLConfig(**base), p0, functools.partial(tv.xent_loss, tlogits),
                      functools.partial(tv.accuracy, tlogits), cx, cy, test, device="cpu")
    return js, ts


def test_batch_indices_follow_the_key_schedule():
    js, ts = _sims()
    jkey, tkey = jax.random.PRNGKey(0), prng.key(0)
    ids = torch.arange(N_CLIENTS)
    for _ in range(3):
        jkey, jkb, _ = jax.random.split(jkey, 3)
        tkey, tkb, _ = prng.split(tkey, 3)
        want = jax.vmap(lambda m: jr._client_batch_idx(js.ctx, jkb, m))(np.arange(N_CLIENTS))
        got = tr._client_batch_idx(ts.ctx, tkb, ids)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        np.testing.assert_array_equal(
            np.asarray(jr.round_batches(js.ctx, jkb)["y"]), tr.round_batches(ts.ctx, tkb)["y"].numpy()
        )


STAGE_CASES = [
    ("mlp", {}),
    ("mlp", {"error_feedback": True}),
    ("mlp", {"byz_frac": 0.34, "attack": "bit_flip"}),
    ("mlp", {"dp_epsilon": 0.5}),
    ("mlp", {"use_kernels": False}),
    ("cnn", {}),
    ("cnn", {"error_feedback": True}),
]


@pytest.mark.parametrize("model,kw", STAGE_CASES,
                         ids=["plain", "ef", "bit_flip", "dp", "chunked_wire", "cnn-plain", "cnn-ef"])
def test_stage_jax_deltas_through_port_server(model, kw):
    """JAX _client_uploads' deltas, fed to the port's compress -> estimate
    -> _finish_round: wire bytes, theta_hat and b exact (the CNN's deltas
    come from the reference's own NHWC convolutions)."""
    js, ts = _sims(model, **kw)
    jctx, tctx = js.ctx, ts.ctx
    params = jr.cell_params(jctx.cfg)
    jkey, tkey = jax.random.fold_in(jax.random.PRNGKey(9), 1), prng.fold_in(prng.key(9), 1)
    state = js.state
    # give the EF path a non-zero carry and b a non-default value
    state = jr.RoundState(w_global=state.w_global, w_locals=state.w_locals,
                          b=jr.BState(b=np.float32(0.0123), prev_vote=np.float32(0.0)),
                          residuals=0.001 * jax.random.normal(jax.random.PRNGKey(2), state.residuals.shape))
    batches = jr.round_batches(jctx, jax.random.PRNGKey(5))
    up = jax.jit(lambda k, s, b: jr._client_uploads(jctx, params, k, s, b))
    sel, w_new, lb, la, deltas_att, jwire, jres = up(jkey, state, batches)
    jtheta = jax.jit(jctx.pipeline.estimate)(jwire)

    t_state = tr.RoundState(
        w_global=torch.from_numpy(np.array(state.w_global)),
        w_locals=torch.from_numpy(np.array(state.w_locals)),
        b=tr.BState(b=torch.tensor(np.float32(0.0123)), prev_vote=torch.tensor(0.0)),
        residuals=torch.from_numpy(np.array(state.residuals)),
    )
    _, k_q = prng.split(prng.fold_in(tkey, 1), 2)
    twire, tres = tctx.pipeline.compress_wire(
        k_q, torch.from_numpy(np.array(deltas_att)), t_state.b.b, t_state.residuals, flip_n=tctx.flip_n
    )
    np.testing.assert_array_equal(np.asarray(jwire.packed), twire.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    ttheta = tctx.pipeline.estimate(twire)
    np.testing.assert_array_equal(np.asarray(jtheta), ttheta.numpy())

    jnew, _ = jax.jit(lambda s, *a: jr._finish_round(jctx, s, *a, jr.RoundState))(
        state, sel, w_new, lb, la, jres, jtheta, deltas_att
    )
    t2 = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tnew, met = tr._finish_round(tctx, t_state, t2(w_new), t2(lb), t2(la), tres, ttheta, t2(deltas_att))
    assert np.float32(jnew.b.b) == tnew.b.b.item()
    assert met["b"].item() == tnew.b.b.item()


@pytest.mark.parametrize("kw", [
    {},
    {"error_feedback": True},
    {"byz_frac": 0.34, "attack": "sign_flip"},
    {"byz_frac": 0.34, "attack": "bit_flip"},
    {"byz_frac": 0.34, "attack": "zero_gradient"},
    {"dp_epsilon": 0.5, "dp_accountant": "advanced"},
], ids=["plain", "ef", "sign_flip", "bit_flip", "zero_gradient", "dp"])
def test_flsimulation_end_to_end(kw):
    """Three rounds of both simulations (JAX's use_kernels resolves to its
    ref engine on the CPU). The b trajectory is exact and the loss within
    float tolerance. w_global: theta_hat is exact given equal deltas, but
    the deltas differ in the last bits (XLA contracts the prox step into
    fused multiply-adds, and the autograd and XLA gradients sum in other
    orders), so a bit whose uniform lies within an ulp of its probability
    may flip: such a coordinate differs by exactly 2b/M. XLA also fuses
    w + theta into one FMA, so the others agree to an ulp, not exactly."""
    js, ts = _sims(**kw)
    jh = js.run(eval_every=1)
    th = ts.run(eval_every=1)
    assert [h["b"] for h in jh] == [h["b"] for h in th]
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=1e-4)
    np.testing.assert_allclose([h["eps_spent"] for h in th], [h["eps_spent"] for h in jh], rtol=0, atol=0)
    diff = np.abs(np.asarray(js.w_global) - ts.w_global.numpy())
    bad = diff > 1e-5
    assert bad.sum() <= 0.001 * diff.size
    flips = np.array([2 * h["b"] / N_CLIENTS for h in [{"b": 0.01}] + th[:-1]])
    for v in diff[bad]:
        assert np.min(np.abs(v - flips)) <= 1e-6, v


def _jax_rounds(js):
    """JAX FLSimulation.run's loop, keeping every round's metrics."""
    key, out = jax.random.PRNGKey(js.cfg.seed), []
    for _ in range(js.cfg.rounds):
        key, kb, kr = jax.random.split(key, 3)
        js.state, met = js._round(kr, js.state, js._round_batches(kb))
        js.ledger.record_round()
        out.append({k: float(met[k]) for k in ("loss", "b", "theta_mse")})
    return out


@pytest.mark.parametrize("kw", [
    {"aggregator": "fedavg"},
    {"aggregator": "fed_gm"},
    {"aggregator": "signsgd_mv"},
    {"aggregator": "rsa", "agg_step": 0.002},
    {"byz_frac": 0.2, "attack": "gaussian"},
    {"byz_frac": 0.2, "attack": "alie"},
    {"byz_frac": 0.2, "attack": "ipm"},
    {"byz_frac": 0.2, "attack": "sample_duplicate"},
    {"aggregator": "signsgd_mv", "byz_frac": 0.2, "attack": "gaussian"},
    {"aggregator": "fedavg", "byz_frac": 0.2, "attack": "bit_flip"},
    {"aggregator": "fed_gm", "byz_frac": 0.2, "attack": "zero_gradient", "gm_iters": 4},
    {"b_mode": "oracle"},
    {"b_mode": "oracle", "dp_epsilon": 0.5, "error_feedback": True},
    {"participation": 0.5},
    {"participation": 0.5, "byz_frac": 0.4, "attack": "alie", "error_feedback": True},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_flsimulation_end_to_end_new_paths(kw):
    """Three rounds of both simulations at 10 clients, round by round: b
    exact, loss and theta_mse within the tolerance of
    test_flsimulation_end_to_end (the deltas agree to float tolerance, not
    bit for bit; see there)."""
    js, ts = _sims(n_clients=10, **kw)
    jm = _jax_rounds(js)
    tm = [{k: float(met[k]) for k in ("loss", "b", "theta_mse")} for _, met in ts.iter_rounds()]
    assert [m["b"] for m in tm] == [m["b"] for m in jm]
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=1e-4)
    np.testing.assert_allclose([m["theta_mse"] for m in tm], [m["theta_mse"] for m in jm], rtol=1e-4, atol=1e-12)
    assert ts.eps_trajectory.tolist() == js.eps_trajectory.tolist()


def test_participation_samples_the_reference_cohort():
    """The active cohort, the gather of its state and batches, and the
    write-back at sel: the JAX round's uploads fed through the port's
    epilogue update exactly the sampled rows."""
    js, ts = _sims(n_clients=10, participation=0.5, error_feedback=True)
    jctx, tctx = js.ctx, ts.ctx
    params = jr.cell_params(jctx.cfg)
    jkey, tkey = jax.random.PRNGKey(4), prng.key(4)
    batches = jr.round_batches(jctx, jax.random.PRNGKey(5))
    sel, w_new, lb, la, deltas_att, jwire, jres = jax.jit(
        lambda k, s, b: jr._client_uploads(jctx, params, k, s, b))(jkey, js.state, batches)
    tsel = prng.choice(prng.fold_in(tkey, 99), 10, (5,))
    np.testing.assert_array_equal(np.asarray(sel), tsel.numpy())
    t2 = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    theta = jax.jit(jctx.pipeline.estimate)(jwire)
    jnew, _ = jax.jit(lambda s, *a: jr._finish_round(jctx, s, *a, jr.RoundState))(
        js.state, sel, w_new, lb, la, jres, theta, deltas_att
    )
    tnew, _ = tr._finish_round(tctx, ts.state, t2(w_new), t2(lb), t2(la), t2(jres), t2(theta), t2(deltas_att), tsel)
    np.testing.assert_array_equal(np.asarray(jnew.w_locals), tnew.w_locals.numpy())
    np.testing.assert_array_equal(np.asarray(jnew.residuals), tnew.residuals.numpy())


@pytest.mark.parametrize("accountant", ACCOUNTANTS)
def test_ledger_at_partial_participation(accountant):
    """Each config's ledger samples at the realized cohort, q = 5/10."""
    kw = dict(n_clients=10, participation=0.5, dp_epsilon=0.5, dp_accountant=accountant)
    j, t = JConfig(**kw).ledger(), FLConfig(**kw).ledger()
    assert t.q == j.q == 0.5
    for _ in range(7):
        j.record_round()
        t.record_round()
    assert t.eps_spent == j.eps_spent
    np.testing.assert_array_equal(t.trajectory(), j.trajectory())


def test_flsimulation_needs_a_card_unless_told(monkeypatch):
    p0, cx, cy, test = _task()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLSimulation(FLConfig(n_clients=N_CLIENTS), p0, None, None, cx, cy, test)


@pytest.mark.parametrize("kw", [
    {"tree_edges": 2},
    {"topk_frac": 0.5},
    {"wire_bits": 2},
    {"client_bits": (1, 2)},
    {"stream_shard": True},
    {"edge_buffer": 1},
    {"tree_shard": True},
    {"byz_edges": 1},
    {"edge_merge": "median"},
    {"edge_trim": 1},
])
def test_unported_options_raise(kw):
    """The options that raised NotImplementedError until the k-bit, top-k,
    tree and sharded paths were ported (ROADMAP A8-A10, A14a): the port now
    does with each what the reference's FLConfig does (the same ValueError
    message, or acceptance)."""
    cfg = dict(n_clients=N_CLIENTS, **kw)
    try:
        JConfig(**cfg)
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            FLConfig(**cfg)
    else:
        FLConfig(**cfg)


@pytest.mark.parametrize("kw", [{"client_chunk": 2}, {"async_buffer": 2}])
def test_streaming_and_async_options_run(kw):
    """The options of the streaming and asynchronous rounds, which raised
    before those rounds were ported: the reference accepts the config, and
    the port runs a round of it to a finite loss."""
    p0, cx, cy, test = _task()
    cfg = dict(n_clients=N_CLIENTS, rounds=1, local_epochs=1, **kw)
    JConfig(**cfg)
    ts = FLSimulation(FLConfig(**cfg), p0, functools.partial(tv.xent_loss, tv.mlp_logits),
                      functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")
    (_, met), = ts.iter_rounds()
    assert np.isfinite(met["loss"].item()) and met["theta"].shape == (ts.d,)


@pytest.mark.parametrize("kw", [{"aggregator": "nope"}, {"attack": "nope"}, {"b_mode": "nope"},
                                {"attack": "straggler"}, {"dp_accountant": "nope"}])
def test_bad_options_raise_value_error(kw):
    with pytest.raises(ValueError):
        FLConfig(**kw)


@pytest.mark.parametrize("kw", [
    {"participation": 0.0}, {"participation": 1.5}, {"participation": -0.5},
    {"aggregator": "krum"}, {"b_mode": "adaptive"}, {"attack": "straggler+none"},
    {"attack": "straggler+alie"}, {"attack": "straggler+nope"}, {"pack_chunk": 12},
    {"stateless_clients": True},
])
def test_rejections_match_reference(kw):
    """What the reference's FLConfig rejects with a ValueError, the port
    rejects with one too."""
    with pytest.raises(ValueError):
        JConfig(**kw)
    with pytest.raises(ValueError):
        FLConfig(**kw)
