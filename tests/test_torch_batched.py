"""The batched forms of the four kernels' plain versions and the batched
synchronous round (fl_round with a leading E), on the CPU.

A group of E runs goes through each kernel entry in one call. Its plain
version must equal ``jax.vmap`` of the reference's ``kernels/ops.py``
function bit for bit (``engine="ref"``, and ``engine="interpret"`` on one
tiny shape), and E separate calls of the port's own. The prox step is exact
against its separate-op f32 formula and within ``test_prox_sgd``'s
tolerance of JAX's, whose jitted step contracts into fused multiply-adds.
``fl_round``'s group form at E = 1 and E = 3 gives each run its own
single ``fl_round`` run bit for bit, state and metrics.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402,F401
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.fl import FLConfig  # noqa: E402
from repro_torch.fl import rounds as tr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.bit_aggregate import bit_aggregate as bit_aggregate_wrapper  # noqa: E402
from repro_torch.kernels.prox_sgd import launch_geometry, prox_sgd as prox_sgd_wrapper  # noqa: E402
from repro_torch.kernels.stoch_quant import stoch_quant_ef, stoch_quant_pack  # noqa: E402
from repro_torch.sim import batched  # noqa: E402
from repro_torch.sim.campaign import _batched_inputs  # noqa: E402
from test_torch_round import _one_torch_thread, _sims  # noqa: E402,F401

E = 3


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _keys(seed, e=E):
    jkeys = jax.random.split(jax.random.PRNGKey(seed), e)
    return jkeys, torch.from_numpy(np.asarray(jkeys).astype(np.int64))


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("d,m", [(997, 4), (8193, 2)])
def test_stoch_quant_compress_group_vs_jax_vmap(d, m, ef):
    """Each run with its own key and range: the group's wire and residuals
    equal jax.vmap of the reference's compress, and E single calls."""
    jkeys, tkeys = _keys(d + m)
    deltas = _rand((E, m, d), 1, 0.02)
    res = _rand((E, m, d), 2, 0.005)
    b = np.repeat(np.asarray([0.01, 0.02, 0.005], np.float32)[:, None], d, 1)
    eff = deltas + res if ef else deltas
    jp, jr = jax.vmap(lambda k, x, bb: jops.stoch_quant_compress_batch(
        k, x, bb, row_offset=1, want_residual=ef, engine="ref"))(jkeys, eff, b)
    tp, trs = ops.stoch_quant_compress_batch(
        tkeys, torch.from_numpy(deltas), torch.from_numpy(b),
        residual=torch.from_numpy(res) if ef else None, row_offset=1, want_residual=ef)
    assert tp.shape == (E, m, ops.padded_len(d) // 8)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    if ef:
        np.testing.assert_array_equal(np.asarray(jr), trs.numpy())
    for i in range(E):
        one, one_res = ops.stoch_quant_compress_batch(
            tkeys[i], torch.from_numpy(deltas[i]), torch.from_numpy(b[i]),
            residual=torch.from_numpy(res[i]) if ef else None, row_offset=1, want_residual=ef)
        assert torch.equal(one, tp[i]) and (not ef or torch.equal(one_res, trs[i]))


def test_stoch_quant_compress_group_vs_jax_interpret():
    """Against the Pallas kernel itself, vmapped over the group, in
    interpret mode (tiny shape)."""
    jkeys, tkeys = _keys(5, 2)
    deltas = _rand((2, 2, 300), 3, 0.02)
    b = np.full((2, 300), 0.01, np.float32)
    b[1] = 0.03
    jp, _ = jax.vmap(lambda k, x, bb: jops.stoch_quant_compress_batch(k, x, bb, engine="interpret"))(
        jkeys, deltas, b)
    tp, _ = ops.stoch_quant_compress_batch(tkeys, torch.from_numpy(deltas), torch.from_numpy(b))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_stoch_quant_kernel_entries_take_a_range_row_per_run():
    """The B1/B2 wrappers (plain versions here) range row r by b's row
    r // (R/E), and equal E single calls."""
    m, d_pad = 5, 2048
    delta = torch.from_numpy(_rand((E * m, d_pad), 1, 0.02))
    res = torch.from_numpy(_rand((E * m, d_pad), 2, 0.005))
    u = torch.rand(E * m, d_pad, generator=torch.Generator().manual_seed(0))
    b = torch.from_numpy(np.abs(_rand((E, d_pad), 3, 0.02)))
    packed = stoch_quant_pack(delta, b, u)
    got = stoch_quant_ef(delta, res, b, u)
    for i in range(E):
        rows = slice(i * m, (i + 1) * m)
        assert torch.equal(packed[rows], stoch_quant_pack(delta[rows], b[i], u[rows]))
        want = ref.stoch_quant_compress_ref(delta[rows], b[i], u[rows], res[rows], want_residual=True)
        assert torch.equal(got[0][rows], want[0]) and torch.equal(got[1][rows], want[1])
    with pytest.raises(ValueError):
        stoch_quant_pack(delta[:-1].contiguous(), b, u[:-1].contiguous())  # 14 rows in 3 runs


@pytest.mark.parametrize("n,m", [(997, 5), (4096, 300)])
def test_bit_aggregate_group_vs_jax_vmap(n, m):
    """Each run counted over its own rows with its own range: jax.vmap of
    the reference's estimate, the wrapper and E single calls agree."""
    p = ops.padded_len(n) // 8
    packed = np.random.default_rng(n).integers(0, 256, (E, m, p), dtype=np.uint8)
    b = np.abs(_rand((E, n), n + 1))
    want = np.asarray(jax.vmap(lambda x, bb: jops.bit_aggregate(x, bb, n, engine="ref"))(packed, b))
    got = ops.bit_aggregate(torch.from_numpy(packed), torch.from_numpy(b), n)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want, bit_aggregate_wrapper(torch.from_numpy(packed), torch.from_numpy(b)).numpy())
    for i in range(E):
        assert torch.equal(got[i], ops.bit_aggregate(torch.from_numpy(packed[i]), torch.from_numpy(b[i]), n))


def test_bit_aggregate_group_vs_jax_interpret():
    n, m = 300, 3
    p = ops.padded_len(n) // 8
    packed = np.random.default_rng(1).integers(0, 256, (2, m, p), dtype=np.uint8)
    b = np.abs(_rand((2, n), 2))
    want = np.asarray(jax.vmap(lambda x, bb: jops.bit_aggregate(x, bb, n, engine="interpret"))(packed, b))
    np.testing.assert_array_equal(want, ops.bit_aggregate(torch.from_numpy(packed), torch.from_numpy(b), n).numpy())


@pytest.mark.parametrize("rows", [1, 5])
def test_prox_sgd_group(rows):
    """Each run's rows step against its own w0 row with its own (eta, lam,
    mu): exact against the separate-op f32 formula and E single calls, in
    place too, and within test_prox_sgd's tolerance of jax.vmap of the
    reference's step."""
    d = 3333
    w, g = _rand((E * rows, d), 1), _rand((E * rows, d), 2)
    mom = _rand((E * rows, d), 3, 0.1)
    w0 = 0.9 * _rand((E, d), 4)
    eta, lam, mu = (np.asarray(v, np.float32) for v in ([0.01, 0.02, 0.05], [0.2, 0.0, 0.5], [0.5, 0.9, 0.0]))
    coeffs = ops.prox_coeffs(*(torch.from_numpy(v) for v in (eta, lam, mu)))
    assert coeffs.shape == (E, 3)
    tw, tm = ops.prox_sgd(*(torch.from_numpy(x) for x in (w, w0, g, mom)), coeffs)
    per = lambda v: np.repeat(v, rows)[:, None]  # noqa: E731
    w0_rows = np.repeat(w0, rows, axis=0)
    nm = per(mu) * mom + (g + per(lam) * (w - w0_rows))
    np.testing.assert_array_equal(tm.numpy(), nm)
    np.testing.assert_array_equal(tw.numpy(), w - per(eta) * nm)
    for i in range(E):
        r = slice(i * rows, (i + 1) * rows)
        one = prox_sgd_wrapper(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (w[r], w0[i], g[r], mom[r])),
                               coeffs[i:i + 1].contiguous())
        assert torch.equal(one[0], tw[r]) and torch.equal(one[1], tm[r])
    w_io, m_io = torch.from_numpy(w.copy()), torch.from_numpy(mom.copy())
    ops.prox_sgd(w_io, torch.from_numpy(w0), torch.from_numpy(g), m_io, coeffs, out=(w_io, m_io))
    assert torch.equal(w_io, tw) and torch.equal(m_io, tm)
    jw, jm = jax.vmap(lambda *a: jops.prox_sgd(*a, engine="ref"))(
        w, w0_rows, g, mom, np.repeat(eta, rows), np.repeat(lam, rows), np.repeat(mu, rows))
    f32eps = np.finfo(np.float32).eps
    tol_m = 2 * f32eps * (np.abs(g) + np.abs(per(lam) * (w - w0_rows)) + np.abs(per(mu) * mom))
    tol_w = 2 * f32eps * (np.abs(w) + per(eta) * (np.abs(nm) + tol_m))
    assert np.all(np.abs(np.asarray(jm) - nm) <= tol_m)
    assert np.all(np.abs(np.asarray(jw) - tw.numpy()) <= tol_w)


def test_prox_sgd_group_vs_jax_interpret():
    """Against the Pallas prox kernel itself, vmapped over a group of two
    runs of 3 rows in interpret mode (tiny shape), within test_prox_sgd's
    tolerance (the interpreted kernel's step contracts into fused
    multiply-adds on the CPU; the port rounds every operation)."""
    rows, d = 3, 1030
    w, g = _rand((2 * rows, d), 5), _rand((2 * rows, d), 6)
    mom = _rand((2 * rows, d), 7, 0.1)
    w0 = _rand((2, d), 8)
    eta, lam, mu = (np.asarray(v, np.float32) for v in ([0.01, 0.05], [0.2, 0.5], [0.5, 0.0]))
    tw, tm = ops.prox_sgd(*(torch.from_numpy(x) for x in (w, w0, g, mom)),
                          ops.prox_coeffs(*(torch.from_numpy(v) for v in (eta, lam, mu))))
    w0_rows, per = np.repeat(w0, rows, axis=0), (lambda v: np.repeat(v, rows)[:, None])
    jw, jm = jax.vmap(lambda *a: jops.prox_sgd(*a, engine="interpret"))(
        w, w0_rows, g, mom, np.repeat(eta, rows), np.repeat(lam, rows), np.repeat(mu, rows))
    f32eps = np.finfo(np.float32).eps
    nm = tm.numpy()
    tol_m = 2 * f32eps * (np.abs(g) + np.abs(per(lam) * (w - w0_rows)) + np.abs(per(mu) * mom))
    tol_w = 2 * f32eps * (np.abs(w) + per(eta) * (np.abs(nm) + tol_m))
    assert np.all(np.abs(np.asarray(jm) - nm) <= tol_m)
    assert np.all(np.abs(np.asarray(jw) - tw.numpy()) <= tol_w)


def _units(per, d, elements, geometry):
    """(element, rows, columns) of each of B4's units in the kernel's order
    (csrc/prox_sgd.cu: tile first, then row groups of each element)."""
    tile, rows, ctas = geometry
    tiles, groups = -(-d // tile), -(-per // rows)
    for u in range(tiles * elements * groups):
        t, g = u % tiles, u // tiles
        e, first = g // groups, (g % groups) * rows
        yield e, slice(e * per + first, e * per + min(per, first + rows)), slice(t * tile, min(d, (t + 1) * tile))


@pytest.mark.parametrize("per,d,elements", [(1, 997, 8), (7, 4099, 3), (100, 118_282, 8), (5, 11_172_042, 3),
                                            (3, 11_172_042, 8)])
def test_prox_sgd_geometry_units_stay_in_one_element(per, d, elements):
    """launch_geometry's units over a group tile every row of every run
    exactly once and never straddle two runs, so a unit stages one w0 row
    (row groups that do not divide the run's rows included)."""
    geometry = launch_geometry(per, d, 132, 3, elements)
    assert geometry[2] == sum(1 for _ in _units(per, d, elements, geometry))
    rows = np.zeros(elements * per, np.int64)
    for e, r, c in _units(per, d, elements, geometry):
        assert e * per <= r.start < r.stop <= (e + 1) * per
        rows[r] += c.stop - c.start
    assert (rows == d).all()


ROUND_CASES = [
    {},
    {"error_feedback": True},
    {"byz_frac": 0.34, "attack": "bit_flip"},
    {"byz_frac": 0.34, "attack": "alie"},
    {"participation": 0.5, "n_clients": 10, "error_feedback": True},
    {"b_mode": "oracle"},
    {"dp_epsilon": 0.5},
    {"aggregator": "fedavg", "byz_frac": 0.34, "attack": "bit_flip"},
    {"aggregator": "fed_gm", "gm_iters": 4},
    {"aggregator": "signsgd_mv"},
    {"use_kernels": False},
]


def _run(state: tr.RoundState, i: int) -> tr.RoundState:
    """Run ``i`` of a group's state."""
    return tr.RoundState(state.w_global[i], state.w_locals[i], tr.BState(state.b.b[i], state.b.prev_vote[i]),
                         state.residuals[i])


def _same_state(a: tr.RoundState, b: tr.RoundState):
    for f in ("w_global", "w_locals", "residuals"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.b.b, b.b.b) and torch.equal(a.b.prev_vote, b.b.prev_vote)


@pytest.mark.parametrize("kw", ROUND_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_batched_round_equals_fl_round(kw):
    """Two rounds of a group of 3 runs (seeds 0-2) and of a group of 1
    through fl_round's group form: each run of either group equals its own
    single fl_round run bit for bit (state and metrics)."""
    ctx = _sims(**kw)[1].ctx
    groups = {}
    for n in (1, E):
        params, keys, state = _batched_inputs(ctx, [ctx.cfg], (0, 1, 2)[:n])
        groups[n] = [batched.device_params(params, ctx.device), keys, state]
    singles = [[key, tr.init_state(ctx, np.float32(ctx.cfg.b_init))] for key in groups[E][1]]
    params = tr.cell_params(ctx.cfg)
    for _ in range(2):
        metrics = {}
        for n, g in groups.items():
            g[1], kb, kr = tr.prng.split(g[1], 3).unbind(-2)
            g[2], metrics[n] = tr.fl_round(ctx, g[0], kr, g[2], tr.round_batches(ctx, kb))
        for i, run in enumerate(singles):
            run[0], kb, kr = tr.prng.split(run[0], 3)
            run[1], met = tr.fl_round(ctx, params, kr, run[1], tr.round_batches(ctx, kb))
            for n, gmet in metrics.items():
                if i < n:
                    for name in ("loss", "b", "theta_mse", "theta"):
                        assert torch.equal(gmet[name][i], met[name]), (n, i, name)
                    _same_state(_run(groups[n][2], i), run[1])


def test_batched_round_leaves_its_state_and_reads_per_run_knobs():
    """The incoming group state is left as it was, and runs of one group
    with other lr, lam, momentum and b_init each equal their own run."""
    _, ts = _sims(error_feedback=True)
    cfgs = [FLConfig(**{**vars(ts.cfg), **kw}) for kw in ({}, {"lr": 0.03, "lam": 0.0}, {"momentum": 0.9, "b_init": 0.02})]
    ctx = ts.ctx
    params, keys, group = _batched_inputs(ctx, cfgs, (4,))
    before = {f: getattr(group, f).clone() for f in ("w_global", "w_locals", "residuals")}
    kk, kb, kr = tr.prng.split(keys, 3).unbind(-2)
    new, met = tr.fl_round(ctx, batched.device_params(params, ctx.device), kr, group, tr.round_batches(ctx, kb))
    for f, t in before.items():
        assert torch.equal(getattr(group, f), t), f
    for i, cfg in enumerate(cfgs):
        state, m = tr.fl_round(ctx, tr.cell_params(cfg), kr[i], tr.init_state(ctx, np.float32(cfg.b_init)),
                               tr.round_batches(ctx, kb[i]))
        assert torch.equal(met["theta"][i], m["theta"]) and torch.equal(met["loss"][i], m["loss"])
        assert torch.equal(new.w_locals[i], state.w_locals) and torch.equal(new.b.b[i], state.b.b)


def test_group_state_is_the_runs_init_state():
    """init_group_state makes each run's init_state, stacked, and a group
    of runs is refused by the round that runs one run at a time (the
    tree's)."""
    ctx = _sims()[1].ctx
    b_inits = np.asarray([0.01, 0.02], np.float32)
    group = batched.init_group_state(ctx, b_inits)
    for i, b0 in enumerate(b_inits):
        _same_state(_run(group, i), tr.init_state(ctx, b0))
    sctx = _sims(client_chunk=3, tree_edges=2)[1].ctx
    with pytest.raises(ValueError, match="group of runs"):
        tr.run_rounds(sctx, tr.cell_params(sctx.cfg), torch.stack([tr.prng.key(0)] * 2), group, rounds=1)
