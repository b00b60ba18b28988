"""The port's MLP, loss, gradient and local solver against the JAX
package's, at weights carried over with repro_torch.interop."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import repro  # noqa: E402,F401
from repro.models import vision as jv  # noqa: E402
from repro.optim import local_prox_train as j_local_prox_train  # noqa: E402
from repro_torch import interop, prng  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from repro_torch.optim import local_prox_train as t_local_prox_train  # noqa: E402

HIDDEN = 16


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_thread_pool():
    """In a pytest process that has already run JAX's interpret-mode kernel
    tests, the first parallel region of torch's CPU thread pool has been
    seen to evaluate transcendental functions (exp, erfinv) up to ~7e-5
    off on its worker threads' chunks; every later region computes them
    exactly, and a process without JAX never shows it. One throwaway
    parallel op takes the pool past that first region before the losses
    below are compared."""
    torch.exp(torch.linspace(-1.0, 1.0, 1 << 20, dtype=torch.float64))


def _params(seed=0, hidden=HIDDEN):
    p = jv.init_mlp(jax.random.PRNGKey(seed), hidden=hidden)
    # non-zero biases so their gradients and ravel slots are exercised
    return {k: np.asarray(v) + (0.01 if k.startswith("b") else 0.0) for k, v in p.items()}


def _batch(n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 784)).astype(np.float32), rng.integers(0, 10, n).astype(np.int32)


def test_ravel_order_matches_ravel_pytree():
    p = _params()
    jflat, junravel = ravel_pytree(p)
    flat, unravel = interop.ravel_params(p)
    np.testing.assert_array_equal(np.asarray(jflat), flat.numpy())
    np.testing.assert_array_equal(flat.numpy(), interop.params_from_jax(p).numpy())
    back = unravel(flat)
    for k in p:
        np.testing.assert_array_equal(p[k], back[k].numpy())
    cohort = unravel(torch.stack([flat, 2 * flat]))  # leading client axis
    np.testing.assert_array_equal(cohort["w1"][1].numpy(), 2 * p["w1"])


def test_init_mlp_close_to_reference():
    """Same Threefry uniforms through the same f32 erf_inv (prng.normal),
    times the same f32 scale: the weights are bit for bit the reference's."""
    jp = jv.init_mlp(jax.random.PRNGKey(3), hidden=HIDDEN)
    tp = tv.init_mlp(prng.key(3), hidden=HIDDEN)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_xent_loss_and_grad_at_carried_weights():
    p = _params()
    x, y = _batch(10)
    jflat, junravel = ravel_pytree(p)
    jloss_fn = lambda w: jv.xent_loss(jv.mlp_logits, junravel(w), {"x": x, "y": y})  # noqa: E731
    jl, jg = jax.value_and_grad(jloss_fn)(jflat)
    flat, unravel = interop.ravel_params(p)
    w = flat.clone().requires_grad_(True)
    tl = tv.xent_loss(tv.mlp_logits, unravel(w), {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    (tg,) = torch.autograd.grad(tl, w)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


def test_cohort_loss_is_per_client():
    """Batched over clients, each row is that client's own loss."""
    p = _params()
    flat, unravel = interop.ravel_params(p)
    ws = torch.stack([flat, 0.5 * flat, -flat])
    xs, ys = zip(*(_batch(8, seed=s) for s in range(3)))
    batch = {"x": torch.from_numpy(np.stack(xs)), "y": torch.from_numpy(np.stack(ys))}
    losses = tv.xent_loss(tv.mlp_logits, unravel(ws), batch)
    for i in range(3):
        one = tv.xent_loss(tv.mlp_logits, unravel(ws[i]), {"x": batch["x"][i], "y": batch["y"][i]})
        np.testing.assert_allclose(losses[i].item(), one.item(), rtol=1e-6)
    acc = tv.accuracy(tv.mlp_logits, unravel(ws), batch)
    assert acc.shape == (3,) and bool(((acc >= 0) & (acc <= 1)).all())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_local_prox_train_after_20_steps(use_kernel):
    """The benchmark's local loop (2 epochs of 100 samples, batch 10: 20
    steps), for a cohort of 3 clients from different starting points."""
    p = _params()
    jflat, junravel = ravel_pytree(p)
    m, steps, bs = 3, 20, 10
    rng = np.random.default_rng(5)
    bx = rng.standard_normal((m, steps, bs, 784)).astype(np.float32)
    by = rng.integers(0, 10, (m, steps, bs)).astype(np.int32)
    w_init = np.stack([np.asarray(jflat) * s for s in (1.0, 0.9, 1.1)]).astype(np.float32)
    jloss = functools.partial(jv.xent_loss, jv.mlp_logits)
    train = jax.vmap(
        lambda wi, b: j_local_prox_train(jloss, jflat, wi, junravel, b, lr=0.01, mu=0.5, lam=0.2,
                                         use_kernel=use_kernel)
    )
    jw, jlb, jla = train(jnp.asarray(w_init), {"x": bx, "y": by})
    flat, unravel = interop.ravel_params(p)
    tw, tlb, tla = t_local_prox_train(
        functools.partial(tv.xent_loss, tv.mlp_logits), flat, torch.from_numpy(w_init), unravel,
        {"x": torch.from_numpy(bx), "y": torch.from_numpy(by)}, lr=0.01, mu=0.5, lam=0.2,
        use_kernel=use_kernel,
    )
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tlb.numpy(), np.asarray(jlb), rtol=1e-5)
    np.testing.assert_allclose(tla.numpy(), np.asarray(jla), rtol=1e-4)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_local_prox_train_leaves_w_init_unchanged(use_kernel):
    """The local loop updates its weights and momentum in place from the
    second step on, but never writes into w_init, which the round still
    holds; the result equals the same run from a copy of w_init."""
    p = _params()
    flat, unravel = interop.ravel_params(p)
    m, steps, bs = 3, 4, 5
    rng = np.random.default_rng(9)
    batches = {"x": torch.from_numpy(rng.standard_normal((m, steps, bs, 784)).astype(np.float32)),
               "y": torch.from_numpy(rng.integers(0, 10, (m, steps, bs)).astype(np.int32))}
    w_init = torch.stack([flat * s for s in (1.0, 0.9, 1.1)])
    keep = w_init.clone()
    loss = functools.partial(tv.xent_loss, tv.mlp_logits)
    kw = dict(lr=0.01, mu=0.5, lam=0.2, use_kernel=use_kernel)
    w, lb, la = t_local_prox_train(loss, flat, w_init, unravel, batches, **kw)
    assert torch.equal(w_init, keep)
    assert w.data_ptr() != w_init.data_ptr() and not torch.equal(w, w_init)
    w2, lb2, la2 = t_local_prox_train(loss, flat, keep.clone(), unravel, batches, **kw)
    assert torch.equal(w, w2) and torch.equal(lb, lb2) and torch.equal(la, la2)


def test_data_copies_match_reference():
    """The port's numpy copies of the task data and partitioner."""
    from repro.data import make_classification as j_make, partition_label_skew as j_part
    from repro_torch.data import make_classification as t_make, partition_label_skew as t_part

    (jx, jy), (jxt, jyt) = j_make(3, n_train=500, n_test=50)
    (tx, ty), (txt, tyt) = t_make(3, n_train=500, n_test=50)
    for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(j_part(jy, 7, 2, 30, seed=2), t_part(ty, 7, 2, 30, seed=2)):
        np.testing.assert_array_equal(a, b)
