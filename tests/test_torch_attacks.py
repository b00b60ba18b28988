"""The port's Byzantine attacks against the JAX package's, on the same
deltas and keys: each attack's rewrite of the first n_byz rows, the ALIE
quantile, and bit_flip on the packed and the dense wire."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import aggregation as jagg, attacks as ja  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import aggregation as tagg, attacks as ta  # noqa: E402

M, D = 10, 997


def _deltas(seed=0, m=M, d=D):
    return (0.01 * np.random.default_rng(seed).standard_normal((m, d))).astype(np.float32)


def _both(name, n_byz, seed=0, m=M):
    """The attack of the JAX round (jit, attack id dispatch) and the port's,
    on the same deltas under the round's attack key."""
    deltas = _deltas(seed, m)
    idx = ja.attack_id(name)
    jkey = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 1))[0]
    tkey = prng.split(prng.fold_in(prng.key(seed), 1), 2)[0]
    want = np.asarray(jax.jit(lambda k, u: ja.apply_attack(idx, k, u, n_byz))(jkey, deltas))
    got = ta.apply_attack(ta.attack_id(name), tkey, torch.from_numpy(deltas), n_byz).numpy()
    return deltas, want, got


def test_attack_ids_follow_the_reference():
    assert ta.ATTACK_IDS == ja.ATTACK_IDS
    for name in ja.ATTACKS:
        assert ta.attack_id(name) == ja.attack_id(name)
        assert ta.is_wire_attack(name) == ja.is_wire_attack(name)


@pytest.mark.parametrize("n_byz", [1, 3, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_exact(n_byz, seed):
    """N(0, 100) rows from prng.normal at (n_byz, d), scaled by f32 10."""
    deltas, want, got = _both("gaussian", n_byz, seed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[n_byz:], deltas[n_byz:])
    assert np.std(got[:n_byz]) > 5


@pytest.mark.parametrize("name", ["sign_flip", "bit_flip", "none"])
def test_elementwise_attacks_exact(name):
    _, want, got = _both(name, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["alie", "ipm", "zero_gradient", "sample_duplicate"])
@pytest.mark.parametrize("n_byz", [1, 3, 4])
def test_colluding_attacks(name, n_byz):
    """Means over the honest rows: sums times the f32 reciprocal, the
    reduction order and XLA's fused multiply-adds aside, hence rtol."""
    deltas, want, got = _both(name, n_byz)
    np.testing.assert_array_equal(got[n_byz:], deltas[n_byz:])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert not np.array_equal(got[:n_byz], deltas[:n_byz])


def test_alie_std_is_population_std():
    """jnp.std has ddof = 0; torch.std's default (unbiased) would not
    match. Two honest rows a, b give std |a - b| / 2 exactly."""
    u = np.zeros((4, 3), np.float32)
    u[2], u[3] = [1.0, 2.0, -3.0], [3.0, 2.0, 1.0]
    evil = ta.apply_attack(ta.attack_id("alie"), prng.key(0), torch.from_numpy(u), 2)[0].numpy()
    z = ta.alie_z(4, 2)
    want = np.asarray(ja.apply_attack(ja.attack_id("alie"), jax.random.PRNGKey(0), u, 2))[0]
    np.testing.assert_allclose(evil, want, rtol=1e-6)
    np.testing.assert_allclose(evil, np.float32([2.0, 2.0, -1.0]) - z * np.float32([1.0, 0.0, 2.0]), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 5, 10, 11, 50, 100, 1001])
def test_alie_z_matches_reference(n):
    for n_byz in range(0, n + 1, max(n // 9, 1)):
        assert ta.alie_z(n, n_byz) == ja.alie_z(n, n_byz), (n, n_byz)


def test_attack_without_byzantines_is_identity():
    deltas = torch.from_numpy(_deltas())
    for name in ta.ATTACK_IDS:
        assert ta.apply_attack(ta.attack_id(name), prng.key(0), deltas, 0) is deltas


@pytest.mark.parametrize("n_byz", [1, 4])
def test_flip_wire_packed_and_dense(n_byz):
    """bit_flip inverts packed rows and negates dense rows."""
    deltas = _deltas()
    packed = np.random.default_rng(3).integers(0, 256, (M, 128), dtype=np.uint8)
    jw = ja.flip_wire(jagg.PackedWire(packed=jnp.asarray(packed), b=jnp.ones(D), d=D), n_byz)
    tw = ta.flip_wire(tagg.PackedWire(packed=torch.from_numpy(packed), b=torch.ones(D), d=D), n_byz)
    np.testing.assert_array_equal(np.asarray(jw.packed), tw.packed.numpy())
    jd = ja.flip_wire(jagg.DenseWire(updates=jnp.asarray(deltas)), n_byz)
    td = ta.flip_wire(tagg.DenseWire(updates=torch.from_numpy(deltas)), n_byz)
    np.testing.assert_array_equal(np.asarray(jd.updates), td.updates.numpy())
