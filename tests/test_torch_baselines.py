"""The paper's baselines in the port against the JAX package's: the sign
wire, the signSGD-MV and RSA estimates from vote counts, FedAvg, the
Fed-GM geometric median, the oracle range, and the pipelines that join
them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import aggregation as jagg, bcontrol as jb, privacy as jp, quantizer as jq  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import aggregation as tagg, bcontrol as tb, privacy as tp, quantizer as tq  # noqa: E402


def _deltas(m, d, seed=0, scale=0.01):
    return (scale * np.random.default_rng(seed).standard_normal((m, d))).astype(np.float32)


@pytest.mark.parametrize("m,d,chunk", [(5, 997, 8192), (8, 8192, 8192), (3, 8193, 8192), (4, 100, 64)])
def test_packed_sign_batch_bytes(m, d, chunk):
    """bit = delta >= 0 (so -0.0 and +0.0 pack 1); pad coordinates pack 0."""
    x = _deltas(m, d)
    x[0, :4] = [0.0, -0.0, -1e-30, 1e-30]
    want = np.asarray(jq.packed_sign_batch(jnp.asarray(x), chunk=chunk))
    got = tq.packed_sign_batch(torch.from_numpy(x), chunk=chunk).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [1, 4, 7, 300])
@pytest.mark.parametrize("scheme", ["signsgd_mv", "rsa"])
def test_sign_servers_exact_from_the_same_wire(m, scheme):
    """Votes counted with packed_counts; signSGD-MV is 0 at a tie (even M)."""
    d = 997
    x = _deltas(m, d, seed=m)
    x[:, :5] = np.where(np.arange(m)[:, None] % 2 == 0, 1.0, -1.0)  # ties when m is even
    packed = np.array(jq.packed_sign_batch(jnp.asarray(x)))
    jcls, tcls = {"signsgd_mv": (jagg.SignSGDMVServer, tagg.SignSGDMVServer),
                  "rsa": (jagg.RSAServer, tagg.RSAServer)}[scheme]
    jw = jagg.PackedWire(packed=jnp.asarray(packed), b=jnp.ones(d), d=d)
    tw = tagg.PackedWire(packed=torch.from_numpy(packed), b=torch.ones(d), d=d)
    for step in (0.01, 0.003):
        want = np.asarray(jax.jit(jcls(step=step).aggregate)(jw))
        got = tcls(step=step).aggregate(tw).numpy()
        np.testing.assert_array_equal(got, want)
    if scheme == "signsgd_mv" and m % 2 == 0:
        assert (got[:5] == 0).all()


@pytest.mark.parametrize("m", [1, 3, 10, 100])
def test_fedavg(m):
    """A sum in another order: rtol 1e-6 of each mean, and of the
    summands' scale where the mean nearly cancels."""
    x = _deltas(m, 997, seed=m)
    want = np.asarray(jax.jit(jagg.fedavg_aggregate)(x))
    got = tagg.fedavg_aggregate(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("m,iters", [(3, 16), (10, 16), (10, 4), (30, 16)])
def test_geometric_median(m, iters):
    """16 smoothed Weiszfeld steps from the mean, with outliers the median
    resists."""
    x = _deltas(m, 997, seed=m)
    x[: m // 3] = 5.0  # outlying rows
    want = np.asarray(jax.jit(lambda u: jagg.geometric_median(u, iters))(x))
    got = tagg.geometric_median(torch.from_numpy(x), iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(x).max())
    if m >= 10:
        assert np.abs(got).max() < 1.0


def test_geometric_median_of_equal_rows_is_the_row():
    x = np.tile(_deltas(1, 50), (4, 1))
    got = tagg.geometric_median(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x[0], rtol=1e-6)


@pytest.mark.parametrize("eps", [0.0, 0.5])
def test_oracle_b_exact(eps):
    x = _deltas(7, 997)
    want = np.asarray(jax.jit(lambda u: jb.oracle_b(u, jp.DPConfig(eps, 2e-4)))(x))
    np.testing.assert_array_equal(tb.oracle_b(torch.from_numpy(x), tp.DPConfig(eps, 2e-4)).numpy(), want)


@pytest.mark.parametrize("name", ["fedavg", "fed_gm", "signsgd_mv", "rsa"])
def test_baseline_pipelines_wire_and_estimate(name):
    """The compressor's dense and sign modes and the server behind each
    baseline, JAX pipeline against the port's; PRoBit+'s own knobs (DP, EF,
    oracle b, kernels) leave a baseline untouched."""
    m, d = 6, 997
    x = _deltas(m, d)
    res = np.full((m, d), 0.5, np.float32)
    kw = dict(dp=jp.DPConfig(0.5), b_mode="oracle", error_feedback=True, agg_step=0.004, gm_iters=5,
              use_kernels=True)
    jpipe = jagg.build_pipeline(name, **kw)
    tpipe = tagg.build_pipeline(name, **{**kw, "dp": tp.DPConfig(0.5)})
    assert tpipe.compressor.mode == jpipe.compressor.mode
    assert tpipe.compressor.wire_bytes(d) == jpipe.compressor.wire_bytes(d)
    jwire, jres = jpipe.compress_wire(jax.random.PRNGKey(0), jnp.asarray(x), jnp.float32(0.01), jnp.asarray(res),
                                      flip_n=2)
    twire, tres = tpipe.compress_wire(prng.key(0), torch.from_numpy(x), torch.tensor(0.01), torch.from_numpy(res),
                                      flip_n=2)
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    if name in ("fedavg", "fed_gm"):
        np.testing.assert_array_equal(twire.updates.numpy(), np.asarray(jwire.updates))
    else:
        np.testing.assert_array_equal(twire.packed.numpy(), np.asarray(jwire.packed))
        np.testing.assert_array_equal(twire.b.numpy(), np.asarray(jwire.b))
    want = np.asarray(jax.jit(jpipe.estimate)(jwire))
    np.testing.assert_allclose(tpipe.estimate(twire).numpy(), want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("eps,ef", [(0.0, False), (0.0, True), (0.5, False)])
def test_oracle_b_wire_exact(use_kernels, eps, ef):
    """PRoBit+ with b_mode="oracle": the per-coordinate range (of the
    error-feedback sum when EF is on), the packed wire, the residuals and
    theta_hat, all exact."""
    m, d = 5, 997
    x = _deltas(m, d)
    res = _deltas(m, d, seed=9, scale=0.003)
    kw = dict(b_mode="oracle", error_feedback=ef, use_kernels=use_kernels)
    jpipe = jagg.build_pipeline("probit_plus", dp=jp.DPConfig(eps), **kw)
    tpipe = tagg.build_pipeline("probit_plus", dp=tp.DPConfig(eps), **kw)
    jwire, jres = jax.jit(lambda k, u, r: jpipe.compress_wire(k, u, jnp.float32(0.01), r))(
        jax.random.PRNGKey(2), x, res)
    twire, tres = tpipe.compress_wire(prng.key(2), torch.from_numpy(x), torch.tensor(0.01), torch.from_numpy(res))
    np.testing.assert_array_equal(twire.b.numpy(), np.asarray(jwire.b))
    np.testing.assert_array_equal(twire.packed.numpy(), np.asarray(jwire.packed))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(tpipe.estimate(twire).numpy(), np.asarray(jax.jit(jpipe.estimate)(jwire)))


def test_registry_names_and_knobs():
    assert tagg.available_aggregators() == jagg.available_aggregators()
    assert tagg.build_pipeline("fed_gm", gm_iters=7).server.iters == 7
    assert tagg.build_pipeline("rsa", agg_step=0.02).server.step == 0.02
    assert tagg.build_pipeline("probit_plus", b_mode="oracle").compressor.b_mode == "oracle"
    with pytest.raises(ValueError, match="unknown aggregator"):
        tagg.build_pipeline("krum")
