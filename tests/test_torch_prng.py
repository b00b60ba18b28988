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
