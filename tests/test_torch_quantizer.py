"""The port's one-bit quantizer (repro_torch.core.quantizer) against the
JAX package's: exact bytes, exact counts, exact residuals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import quantizer as jq  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402


def _deltas(m, d, seed=0, scale=0.02):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((m, d))).astype(np.float32)


def test_binarize_prob_matches_jitted_reference():
    """Eq.-5 probabilities (clip, zero-b guard) equal bit for bit, with
    saturated, dead and negative-range coordinates included."""
    rng = np.random.default_rng(1)
    n = 100_000
    delta = (0.02 * rng.standard_normal(n)).astype(np.float32)
    b = np.abs(0.01 * rng.standard_normal(n)).astype(np.float32)
    b[:50] = 0.0
    b[50:60] = -0.01
    delta[60:70] = b[60:70]
    want = np.asarray(jax.jit(jq.binarize_prob)(delta, b))
    got = tq.binarize_prob(torch.from_numpy(delta), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n", [1, 100, 8192, 8193])
def test_client_uniforms(n):
    ck = jax.random.fold_in(jax.random.PRNGKey(2), 5)
    want = np.asarray(jq.client_uniforms(ck, n))
    got = tq.client_uniforms(prng.fold_in(prng.key(2), 5), n).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("m", [1, 5, 9])
@pytest.mark.parametrize("d", [1, 997, 8192, 8193, 40522])
def test_packed_binarize_batch(d, m):
    """Wire bytes and EF residuals, at a non-zero cohort offset."""
    deltas = _deltas(m, d, seed=d + m)
    b = np.full((d,), 0.01, np.float32)
    key = jax.random.PRNGKey(d)
    jp, jr = jq.packed_binarize_batch(key, deltas, b, want_residual=True, row_offset=3)
    tp, tr = tq.packed_binarize_batch(
        prng.key(d), torch.from_numpy(deltas), torch.from_numpy(b), want_residual=True, row_offset=3
    )
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


@pytest.mark.parametrize("d,m", [(997, 5), (40522, 9)])
def test_packed_binarize_batch_without_residual(d, m):
    deltas = _deltas(m, d, seed=7)
    key = jax.random.PRNGKey(1)
    jp, jr = jq.packed_binarize_batch(key, deltas, jnp.float32(0.015))
    tp, tr = tq.packed_binarize_batch(prng.key(1), torch.from_numpy(deltas), torch.tensor(0.015))
    assert jr is None and tr is None
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


@pytest.mark.parametrize("m", [1, 7, 300])
def test_packed_counts(m):
    """Integer vote counts, in int32 (300 clients would wrap a uint8)."""
    rng = np.random.default_rng(m)
    packed = rng.integers(0, 256, (m, 1280), dtype=np.uint8)
    want = np.asarray(jq.packed_counts(packed))
    got = tq.packed_counts(torch.from_numpy(packed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_pack_unpack_bits_roundtrip():
    rng = np.random.default_rng(3)
    codes = np.where(rng.random(1001) < 0.5, 1, -1).astype(np.int8)
    want = np.asarray(jq.pack_bits(codes))
    got = tq.pack_bits(torch.from_numpy(codes))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(codes, tq.unpack_bits(got, 1001).numpy())


@pytest.mark.parametrize("d", [1, 997, 40522])
def test_wire_bytes_and_padded_dim(d):
    assert tq.padded_dim(d) == jq.padded_dim(d)
    for d_pad in (None, tq.padded_dim(d)):
        assert tq.wire_bytes(d, d_pad=d_pad) == jq.wire_bytes(d, d_pad=d_pad)
