"""The port's Mamba mixer (repro_torch.models.ssm) against the reference's
(repro.models.ssm) on the CPU, on the reduced jamba's mixer (d_model 256,
d_in 512, d_state 16, dt_rank 16) with its biases, decays and skips drawn
away from their init so that every path carries signal.

Tolerances, as measured on this CPU:
- the scan: bit for bit with the jitted ``jax.lax.associative_scan`` at
  lengths 1, 7, 8 and 256 (the same odd/even recursion, and the combine's
  multiply-add fused as XLA fuses it);
- ``mamba_block`` with f32 parameters, over one chunk of 32 and over four
  chunks of 8 (the state carried): within rtol 1e-5 and 1e-5 of the largest
  output (measured <= 9.6e-7 of it: the einsums sum in another order and
  torch's exp is not XLA's);
- bf16 parameters: within 2 ** -7 of the largest output with the f32
  state (measured 2 ** -8, one bf16 step), 2 ** -5 with the bf16 state
  (measured 0.047 of 4.2); f32 parameters with the bf16 state within
  2 ** -8 of it (measured 1.8e-3 of it; the state's dtype alone moves the
  reference by 2.8e-3 of it);
- every leaf's gradient of a weighted sum of the output against
  ``jax.grad``: within rtol 1e-5 and 1e-5 of the leaf's largest gradient
  (measured <= 5.2e-7 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import init_params as jip
from repro.models import ssm as jssm
from repro_torch import configs as tc
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import ssm as tssm

ARCH = "jamba-1.5-large-398b"
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixer():
    """Both configs, a Mamba mixer of the reduced jamba as numpy f32 (its
    biases, decays and skips redrawn) and an input."""
    jcfg, tcfg = jc.reduced(jc.get_config(ARCH)), tc.reduced(tc.get_config(ARCH))
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), jip(jssm.mamba_specs(jcfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    d_in, ds = p["a_log"].shape
    p.update(dt_bias=0.5 * rng.standard_normal(d_in), conv_b=0.1 * rng.standard_normal(d_in),
             a_log=0.5 * rng.standard_normal((d_in, ds)), d_skip=rng.standard_normal(d_in))
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, SEQ, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, x


def _op(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


@pytest.mark.parametrize("n", [1, 7, 8, 256])
def test_associative_scan_is_jaxs(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 8, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 8, 4)).astype(np.float32)
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(_op, (a, b), axis=1))(a, b)
    ta, tb = tssm.associative_scan(tssm._combine, (torch.from_numpy(a), torch.from_numpy(b)), dim=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # and it is the recurrence h_t = a_t h_{t-1} + b_t
    h, seq = np.zeros(a[:, 0].shape), []
    for t in range(n):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(tb.numpy(), np.stack(seq, 1), rtol=1e-5, atol=1e-5)


def _close(got: torch.Tensor, want, frac: float):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=frac, atol=frac * np.abs(want).max())


@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba_block_f32(mixer, chunk):
    """Four chunks of 8 carry the state from chunk to chunk; one chunk of
    32 does not; both are the reference's, and each other's."""
    jcfg, tcfg, p, x = mixer
    want = jax.jit(lambda p, x: jssm.mamba_block(p, x, jcfg, chunk=chunk))(p, x)
    got = tssm.mamba_block(lm_params_from_numpy(p, dtype=torch.float32), torch.from_numpy(x), tcfg, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want, 1e-5)
    whole = tssm.mamba_block(lm_params_from_numpy(p, dtype=torch.float32), torch.from_numpy(x), tcfg, chunk=SEQ)
    _close(got, whole.numpy(), 1e-5)
    with pytest.raises(ValueError, match="chunks"):
        tssm.mamba_block(lm_params_from_numpy(p, dtype=torch.float32), torch.from_numpy(x[:, :12]), tcfg, chunk=8)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_mamba_block_bf16_and_the_state_dtype(mixer, state):
    jcfg, tcfg, p, x = mixer
    jp, jx = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p), jnp.asarray(x, jnp.bfloat16)
    with jssm.ssm_state_dtype(state):
        want = jax.jit(lambda p, x: jssm.mamba_block(p, x, jcfg, chunk=8))(jp, jx)
    with tssm.ssm_state_dtype(state):
        got = tssm.mamba_block(lm_params_from_numpy(p), torch.from_numpy(x).bfloat16(), tcfg, chunk=8)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    bar = 2.0**-7 if state == "float32" else 2.0**-5
    assert np.abs(got.float().numpy() - want).max() <= bar * np.abs(want).max()
    assert tssm._SSM_STATE_DTYPE.get() == "float32"


def test_bf16_state_with_f32_parameters(mixer):
    """The bf16 state alone: its scan rounds decays, drives and h to bf16,
    as the reference's does."""
    jcfg, tcfg, p, x = mixer
    tp = lm_params_from_numpy(p, dtype=torch.float32)
    with jssm.ssm_state_dtype("bfloat16"):
        want = np.asarray(jax.jit(lambda p, x: jssm.mamba_block(p, x, jcfg, chunk=8))(p, x))
    with tssm.ssm_state_dtype("bfloat16"):
        got = tssm.mamba_block(tp, torch.from_numpy(x), tcfg, chunk=8)
    f32 = tssm.mamba_block(tp, torch.from_numpy(x), tcfg, chunk=8)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2.0**-8 * np.abs(want).max()
    assert (got - f32).abs().max() > 1e-3 * np.abs(want).max()


def test_every_mamba_gradient_is_jaxs(mixer):
    jcfg, tcfg, p, x = mixer
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x, w: jnp.sum(jssm.mamba_block(p, x, jcfg, chunk=8) * w)))(p, x, w)
    req = {k: v.requires_grad_(True) for k, v in lm_params_from_numpy(p, dtype=torch.float32).items()}
    (tssm.mamba_block(req, torch.from_numpy(x), tcfg, chunk=8) * torch.from_numpy(w)).sum().backward()
    assert sorted(req) == sorted(jg) and len(req) == 9
    for k in sorted(jg):
        _close(req[k].grad, jg[k], 1e-5)


def test_specs_are_the_references(mixer):
    """The nine leaves a Mamba position, their shapes, inits and scales."""
    jcfg, tcfg, _, _ = mixer
    js, ts = jssm.mamba_specs(jcfg), tssm.mamba_specs(tcfg)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert (ts[k].shape, ts[k].init, ts[k].scale) == (js[k].shape, js[k].init, js[k].scale), k
    assert ts["x_proj"].shape == (512, 16 + 2 * 16) and ts["a_log"].init == "ones" and ts["conv_w"].scale == 0.5
