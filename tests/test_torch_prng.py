"""The port's Threefry (repro_torch.prng) against jax.random, bit for bit.

The JAX package pins ``jax_threefry_partitionable`` (importing ``repro``
sets it), so every key and draw is a pure function of (key, index); the
port must reproduce those words exactly for its wire to equal the JAX
wire.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402,F401  (sets jax_threefry_partitionable)
from repro_torch import prng  # noqa: E402


def _np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 123456, 2**31 - 1])
def test_prng_key(seed):
    np.testing.assert_array_equal(_np(jax.random.PRNGKey(seed)), prng.key(seed).numpy())


@pytest.mark.parametrize("data", [0, 1, 99, 2**31 + 5, 2**32 - 1])
def test_fold_in(data):
    k = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(_np(jax.random.fold_in(k, data)), prng.fold_in(prng.key(7), data).numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 100])
def test_split_is_fold_in(n):
    k = jax.random.PRNGKey(3)
    got = prng.split(prng.key(3), n)
    np.testing.assert_array_equal(_np(jax.random.split(k, n)), got.numpy())
    np.testing.assert_array_equal(got.numpy(), prng.fold_in(prng.key(3), torch.arange(n)).numpy())


@pytest.mark.parametrize("n", [1, 7, 8192, 8193])
def test_bits_and_uniform(n):
    k = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    tk = prng.fold_in(prng.key(11), 4)
    np.testing.assert_array_equal(_np(jax.random.bits(k, (n,))), prng.bits(tk, (n,)).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(k, (n,))), prng.uniform(tk, (n,)).numpy())


def test_uniform_2d_and_batched_keys():
    """A 2-D draw counts over the flat index; a batch of keys draws one
    block per key."""
    k = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(k, (3, 5))), prng.uniform(prng.key(5), (3, 5)).numpy()
    )
    keys = prng.fold_in(prng.key(5), torch.arange(4))
    got = prng.uniform(keys, (2, 9))
    for i in range(4):
        want = jax.random.uniform(jax.random.fold_in(k, i), (2, 9))
        np.testing.assert_array_equal(np.asarray(want), got[i].numpy())


@pytest.mark.parametrize("steps,batch,per_client", [(20, 10, 100), (4, 10, 20), (3, 7, 1000)])
def test_randint_at_client_batch_shapes(steps, batch, per_client):
    """The shapes of rounds._client_batch_idx: randint(fold_in(kb, m),
    (steps, batch), 0, per_client), for a cohort of clients at once."""
    kb = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    tkb = prng.fold_in(prng.key(0), 2)
    ids = torch.arange(6)
    got = prng.randint(prng.fold_in(tkb, ids), (steps, batch), 0, per_client)
    for m in range(6):
        want = jax.random.randint(jax.random.fold_in(kb, m), (steps, batch), 0, per_client)
        np.testing.assert_array_equal(np.asarray(want), got[m].numpy())


@pytest.mark.parametrize("seed", [3, 0, 2**31 - 1])
def test_normal_bit_exact_over_2_20_draws(seed):
    """prng.normal against jax.random.normal on 2**20 draws: XLA's f32
    erf_inv over its own log1p and log, fused multiply-adds included."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1 << 20,)))
    got = prng.normal(prng.key(seed), (1 << 20,)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_shapes_and_batched_keys():
    """The gaussian attack's (n_byz, d) draw counts over the flat index; a
    batch of keys draws one block per key."""
    k = jax.random.fold_in(jax.random.PRNGKey(8), 1)
    tk = prng.fold_in(prng.key(8), 1)
    np.testing.assert_array_equal(np.asarray(jax.random.normal(k, (3, 997))), prng.normal(tk, (3, 997)).numpy())
    got = prng.normal(prng.fold_in(tk, torch.arange(3)), (5, 7))
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(jax.random.normal(jax.random.fold_in(k, i), (5, 7))), got[i].numpy())


def test_normal_scale_folds_like_jit():
    """Under jit XLA folds ``10 * (sqrt(2) * erf_inv)`` into one f32 constant
    factor; eagerly the two multiplies round twice."""
    k, tk = jax.random.PRNGKey(3), prng.key(3)
    want = np.asarray(jax.jit(lambda k: 10.0 * jax.random.normal(k, (7, 997)))(k))
    np.testing.assert_array_equal(prng.normal(tk, (7, 997), scale=10.0).numpy(), want)
    assert not np.array_equal(10.0 * np.asarray(jax.random.normal(k, (7, 997))), want)


def test_fma_rounds_once():
    """The emulated fused multiply-add rounds a*b + c once: where the f64
    sum is exact it equals it rounded, and on a case that double rounding
    gets wrong it still gives the correctly rounded result."""
    a = torch.tensor([1.0 + 2.0**-12, 3.0, 0.1], dtype=torch.float32)
    b = torch.tensor([1.0 + 2.0**-12, 7.0, 0.3], dtype=torch.float32)
    c = torch.tensor([-1.0, 0.5, 0.2], dtype=torch.float32)
    exact = a.double() * b.double() + c.double()  # exact here: few bits each
    np.testing.assert_array_equal(prng._fma(a, b, c).numpy(), exact.float().numpy())
    # a * b + c = 256 + 2**-16 + 2**-62 lies just above the f32 tie
    # 256 + 2**-16, so it rounds up to 256 + 2**-15; rounded to f64 first it
    # lands on the tie and rounds to even, 256.
    vals = (2.0**-8 * (1 + 2.0**-23), -(2.0**-8) * (1 - 2.0**-23), 256.0 + 2.0**-15)
    a, b, c = (torch.tensor([v], dtype=torch.float32) for v in vals)
    assert prng._fma(a, b, c).item() == 256.0 + 2.0**-15
    assert (a.double() * b.double() + c.double()).float().item() == 256.0


@pytest.mark.parametrize("n", [1, 7, 100, 1000, 2000])
@pytest.mark.parametrize("seed", [0, 5, 123])
def test_permutation_and_choice(n, seed):
    """One sort round up to n = 1,625, two beyond."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 99)
    tk = prng.fold_in(prng.key(seed), 99)
    np.testing.assert_array_equal(np.asarray(jax.random.permutation(k, n)), prng.permutation(tk, n).numpy())
    for m in {1, max(n // 2, 1), n}:
        want = jax.random.choice(k, n, (m,), replace=False)
        np.testing.assert_array_equal(np.asarray(want), prng.choice(tk, n, (m,)).numpy())


def test_choice_rejects_a_larger_sample():
    with pytest.raises(ValueError, match="larger sample"):
        prng.choice(prng.key(0), 3, (4,))
