"""The port's xLSTM mixers and causal convolution (repro_torch.models.xlstm,
layers.causal_conv1d) against the reference's (repro.models.xlstm,
layers.causal_conv1d) on the CPU, at a narrow xLSTM (d_model 64, 4 heads:
the mLSTM's inner width 128 and head 32, the sLSTM's head 16), 2 x 64
tokens, the mLSTM in chunks of 16 (four chunks carry its state).

Tolerances, as measured on this CPU:
- f32 parameters: the blocks' outputs within rtol 1e-5 and 1e-5 of their
  largest output (measured <= 5.9e-6 of it: ``log_sigmoid``, ``cumsum``
  and the einsums round in another order); every leaf's gradient within
  rtol 1e-4 and 1e-4 of its largest entry;
- bf16 parameters: within 2 ** -9 of the largest output on average of the
  reference's bf16 (measured 1.0e-3 of it for the mLSTM; the sLSTM's is
  bit for bit), and at worst no farther from the f32 output than the
  reference's bf16 is (test_block_bf16);
- the convolution within rtol 1e-6 and 1e-6 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import layers as jL
from repro.models import xlstm as jx
from repro.models.spec import init_params as jip
from repro_torch import configs as tc
from repro_torch import prng, tree
from repro_torch.models import layers as tL
from repro_torch.models import xlstm as tx
from repro_torch.models.spec import init_params as tip

B, S, CHUNK = 2, 64, 16
NARROW = dict(d_model=64, n_heads=4, n_kv_heads=4, d_head=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs():
    return (dataclasses.replace(jc.reduced(jc.get_config("xlstm-350m")), **NARROW),
            dataclasses.replace(tc.reduced(tc.get_config("xlstm-350m")), **NARROW))


def _blocks(jcfg, tcfg):
    return {
        "mlstm": (jx.mlstm_specs, tx.mlstm_specs,
                  lambda p, x: jx.mlstm_block(p, x, jcfg, chunk=CHUNK),
                  lambda p, x: tx.mlstm_block(p, x, tcfg, chunk=CHUNK)),
        "slstm": (jx.slstm_specs, tx.slstm_specs,
                  lambda p, x: jx.slstm_block(p, x, jcfg), lambda p, x: tx.slstm_block(p, x, tcfg)),
    }


@pytest.fixture(scope="module")
def mixers():
    """Per mixer: both parameter trees (the reference's init, bit for bit,
    with the gate weights scaled up so the gates move), the inputs, both
    block functions and the reference's jitted outputs and gradients at
    f32."""
    jcfg, tcfg = cfgs()
    x = np.random.default_rng(1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    wgt = np.random.default_rng(2).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    out = {}
    for name, (jspec, tspec, jfn, tfn) in _blocks(jcfg, tcfg).items():
        jp, tp = jip(jspec(jcfg), jax.random.PRNGKey(4)), tip(tspec(tcfg), prng.key(4))
        for (_, a), c in zip(jax.tree_util.tree_leaves_with_path(jp), tree.leaves(tp)):
            np.testing.assert_array_equal(c.float().numpy(), np.asarray(a, np.float32))
        # larger gate and recurrent weights than the init's 0.01 scale, so the
        # stabilizer and the exponential gates do real work
        for k in ("wi", "wf", "r"):
            if k in jp:
                jp[k] = (jp[k].astype(jnp.float32) * 30).astype(jnp.bfloat16)
                tp[k] = torch.from_numpy(np.asarray(jp[k], np.float32)).to(torch.bfloat16)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        y = np.asarray(jax.jit(jfn)(jp32, x))
        grads = jax.jit(jax.grad(lambda p, x: jnp.sum(jfn(p, x) * wgt), argnums=(0, 1)))(jp32, x)
        out[name] = (jp, tp, x, wgt, tfn, jfn, y, grads)
    return out


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_block_f32(mixers, name):
    jp, tp, x, _, tfn, _, y, _ = mixers[name]
    got = tfn(tree.tree_map(lambda a: a.float(), tp), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == y.shape
    np.testing.assert_allclose(got.numpy(), y, rtol=1e-5, atol=1e-5 * np.abs(y).max())


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_block_gradients_f32(mixers, name):
    """``jax.grad`` of a weighted sum of the block's output, every leaf and
    the input: through the mLSTM's chunk carry, ``amax``, ``cummax`` and the
    stabilizer, and the sLSTM's loop over time."""
    jp, tp, x, wgt, tfn, _, _, (jg, jgx) = mixers[name]
    leaves = [w.float().requires_grad_(True) for w in tree.leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    (tfn(tree.unflatten(tp, leaves), xt) * torch.from_numpy(wgt)).sum().backward()
    for want, got in list(zip(jax.tree.leaves(jg), [w.grad for w in leaves])) + [(jgx, xt.grad)]:
        want = np.asarray(want)
        assert got is not None and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_block_bf16(mixers, name):
    """bf16 against the reference's bf16 on average, and against the f32
    result no worse than the reference's own bf16 at the worst position:
    where the mLSTM's normalizer nearly cancels, bf16 rounding is amplified
    (ROADMAP C), and there the reference's bf16 lies 0.56 from the f32
    output where the port's lies 0.10."""
    jp, tp, x, _, tfn, jfn, y, _ = mixers[name]
    want = np.asarray(jax.jit(jfn)(jp, jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = tfn(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    top = np.abs(want).max()
    assert np.abs(got - want).mean() <= 2**-9 * top, np.abs(got - want).mean() / top
    assert np.abs(got - y).max() <= max(np.abs(want - y).max(), 2**-5 * top), (np.abs(got - y).max(),
                                                                                 np.abs(want - y).max())


def test_mlstm_chunks_carry_the_state(mixers):
    """The same sequence in one chunk and in chunks of 16 (the state carried
    across three chunk boundaries) gives the same output within float
    rounding; a sequence that is not a whole number of chunks is refused."""
    jcfg, tcfg = cfgs()
    _, tp, x, _, _, _, y, _ = mixers["mlstm"]
    tp32 = tree.tree_map(lambda a: a.float(), tp)
    whole = tx.mlstm_block(tp32, torch.from_numpy(x), tcfg, chunk=S).numpy()
    np.testing.assert_allclose(whole, y, rtol=1e-5, atol=1e-5 * np.abs(y).max())
    with pytest.raises(ValueError, match="chunks"):
        tx.mlstm_block(tp32, torch.from_numpy(x[:, :40]), tcfg, chunk=CHUNK)


def test_stabilizer_start_underflows():
    """The state starts at m = -1e30: the first chunk's decay of the old
    state is exp(-1e30 + ...) = 0, so its output does not depend on the
    initial C and n, and stays finite; its gradient to them is 0."""
    rng = np.random.default_rng(3)
    h, hd, c = 4, 32, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((1, c, h, hd)).astype(np.float32)) for _ in range(3))
    li = torch.from_numpy(rng.standard_normal((1, c, h)).astype(np.float32))
    lf = torch.nn.functional.logsigmoid(torch.from_numpy(rng.standard_normal((1, c, h)).astype(np.float32)))
    m0 = torch.full((1, h), tx.M_INIT)
    c0 = torch.from_numpy(rng.standard_normal((1, h, hd, hd)).astype(np.float32)).requires_grad_(True)
    n0 = torch.from_numpy(rng.standard_normal((1, h, hd)).astype(np.float32)).requires_grad_(True)
    (c1, n1, m1), y = tx._mlstm_chunk((c0, n0, m0), q, k, v, li, lf)
    (c2, n2, m2), y2 = tx._mlstm_chunk((torch.zeros_like(c0), torch.zeros_like(n0), m0), q, k, v, li, lf)
    assert torch.equal(y, y2) and torch.equal(c1, c2) and torch.equal(n1, n2) and torch.equal(m1, m2)
    assert bool(torch.isfinite(y).all()) and bool((m1 > -1e3).all())
    (y.sum() + c1.sum() + n1.sum()).backward()
    assert not c0.grad.abs().max() and not n0.grad.abs().max()
    want = jax.jit(jx._mlstm_chunk)((jnp.zeros((1, h, hd, hd)), jnp.zeros((1, h, hd)), jnp.full((1, h), -1e30)),
                           tuple(jnp.asarray(t.numpy()) for t in (q, k, v, li, lf)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)


def test_masked_exponent_keeps_gradients_finite():
    """Forgetting of -1 a step over a chunk of 128 drives the exponent above
    the diagonal past f32's exp range (~127 > 88.7): the reference's
    ``where`` after the ``exp`` gives the same outputs as the port's
    masked exponent, but its gradient to the gate inputs is NaN (the
    masked zero times inf) where the port's is finite; q's is finite in
    both. At full width the same happens at chunk 256 (ROADMAP C)."""
    rng = np.random.default_rng(6)
    h, hd, c = 2, 8, 128
    q, k, v = (rng.standard_normal((1, c, h, hd)).astype(np.float32) for _ in range(3))
    li = rng.standard_normal((1, c, h)).astype(np.float32)
    lf = np.full((1, c, h), -1.0, np.float32)
    carry = (np.zeros((1, h, hd, hd), np.float32), np.zeros((1, h, hd), np.float32), np.full((1, h), -1e30, np.float32))
    want_y = np.asarray(jax.jit(lambda *a: jx._mlstm_chunk(carry, a)[1])(q, k, v, li, lf))
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jx._mlstm_chunk(carry, a)[1]), argnums=(0, 3)))(q, k, v, li, lf)
    assert np.isnan(np.asarray(jg[1])).any() and not np.isnan(np.asarray(jg[0])).any()
    tq, tli = torch.from_numpy(q).requires_grad_(True), torch.from_numpy(li).requires_grad_(True)
    _, y = tx._mlstm_chunk(tuple(torch.from_numpy(a) for a in carry), tq, torch.from_numpy(k), torch.from_numpy(v),
                           tli, torch.from_numpy(lf))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5, atol=1e-6)
    y.sum().backward()
    assert bool(torch.isfinite(tq.grad).all()) and bool(torch.isfinite(tli.grad).all())
    assert tq.grad.abs().max() > 0


def test_cummax_and_amax_gradients_are_jaxs():
    """``torch.cummax`` and ``amax`` route the gradient to the running
    maximum as ``jax.lax.cummax`` and ``jnp.max`` do (no ties: the
    values are distinct), up to the order in which a maximum's gradients
    add."""
    x = np.random.default_rng(9).standard_normal((3, 17, 4)).astype(np.float32)
    w = np.random.default_rng(10).standard_normal((3, 17, 4)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda a: jnp.sum(jax.lax.cummax(a, axis=1) * w) + jnp.sum(jnp.max(a, axis=1) * w[:, 0])))(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    ((torch.cummax(xt, dim=1).values * torch.from_numpy(w)).sum() + (xt.amax(1) * torch.from_numpy(w[:, 0])).sum()
     ).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    assert ((xt.grad.numpy() != 0) == (np.asarray(jg) != 0)).all()


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("bias", [True, False])
def test_causal_conv1d(k, bias):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    w = rng.standard_normal((k, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) if bias else None
    want = np.asarray(jax.jit(jL.causal_conv1d)(x, w, b))
    tb = None if b is None else torch.from_numpy(b)
    got = tL.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # causal: output t reads inputs t-k+1..t only
    x2 = x.copy()
    x2[:, 7:] += 1.0
    got2 = tL.causal_conv1d(torch.from_numpy(x2), torch.from_numpy(w), tb)
    assert torch.equal(got[:, :7], got2[:, :7]) and not torch.equal(got[:, 7:], got2[:, 7:])
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    tL.causal_conv1d(xt, wt, tb).square().sum().backward()
    gx, gw = jax.grad(lambda a, c: jnp.sum(jL.causal_conv1d(a, c, b) ** 2), argnums=(0, 1))(x, w)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-5)
