"""The port's top-k sparse wire against the JAX package's.

Exact against the jitted reference: the top-k order among tied
magnitudes (exact zeros and repeated values across the k-th boundary: a
stable descending sort equals ``jax.lax.top_k``), the sparse binarize and
estimate, ``quant_pack_u`` (the pack kernel's plain version) for k not a
multiple of 8, and the compressor's SparseWire (indices, packed codes,
error-feedback residuals, estimate) with and without the kernel wire. End
to end, FLSimulation with ``topk_frac`` on the kernel wire under error
feedback, with the bars of ``tests/test_torch_kbit.py::_hold``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import build_pipeline as jbuild  # noqa: E402
from repro.core import quantizer as jq  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import SparseWire, build_pipeline, wire_bytes  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.fl import FLConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_kbit import _both, _hold, _t  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401


def _tied(rng, m, d):
    """Rows of magnitudes drawn from a few values, zeros most common, so
    ties straddle any k-th position; a fifth of the entries random."""
    x = rng.choice(np.float32([0, 0, 0, 0.5, 0.25, -0.25, -0.5, 1e-3, -1e-3, -0.0]), (m, d)).astype(np.float32)
    mask = rng.random((m, d)) < 0.2
    x[mask] = 0.01 * rng.standard_normal(int(mask.sum())).astype(np.float32)
    return x


@pytest.mark.parametrize("k", [1, 37, 250, 999])
def test_topk_order_with_ties(k):
    """Indices in jax.lax.top_k's order (descending, the lower index first
    among equal magnitudes), exact, for every k across the ties."""
    x = _tied(np.random.default_rng(k), 6, 1000)
    want = jax.jit(lambda x: jax.vmap(lambda r: jax.lax.top_k(jnp.abs(r), k)[1])(x))(x)
    np.testing.assert_array_equal(tsparse.topk_indices(_t(x), k).numpy(), np.asarray(want))


def test_topk_binarize_and_sparse_aggregate_against_reference():
    """topk_binarize with the keys of split(key, M) and sparse_aggregate of
    its codes: indices, codes and theta_hat exact against the jitted
    reference (theta a true division by each coordinate's count)."""
    m, d, k = 7, 500, 61
    x = _tied(np.random.default_rng(0), m, d)
    b = np.full(d, 0.3, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), m)
    jidx, jcodes = jax.jit(jax.vmap(lambda kk, r, b: jsparse.topk_binarize(kk, r, b, k), in_axes=(0, 0, None)))(
        keys, x, b)
    idx, codes = tsparse.topk_binarize(prng.split(prng.key(4), m), _t(x), _t(b), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    want = jax.jit(lambda i, c, b: jsparse.sparse_aggregate(i, c, b, d))(jidx, jcodes, b)
    np.testing.assert_array_equal(tsparse.sparse_aggregate(idx, codes, _t(b), d).numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [5, 1030])
def test_quant_pack_u_against_reference(k):
    """quant_pack_u (ref engine, the pack kernel's plain version) on rows of
    k gathered values, k not a multiple of 8: each row's bytes equal the
    reference's flat call, and its first ceil(k/8) bytes pack_bits of the
    Eq.-5 codes."""
    rng = np.random.default_rng(k)
    m = 3
    d_sel = (0.02 * rng.standard_normal((m, k))).astype(np.float32)
    b_sel = np.abs(0.03 * rng.standard_normal((m, k))).astype(np.float32)
    u = rng.random((m, k), dtype=np.float32)
    want = jax.jit(jax.vmap(lambda x, b, u: jops.quant_pack_u(x, b, u)))(d_sel, b_sel, u)
    got = tops.quant_pack_u(_t(d_sel), _t(b_sel), _t(u), engine="ref")
    assert got.shape == (m, tops.padded_len(k) // 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tops.quant_pack_u(_t(d_sel[0]), _t(b_sel[0]), _t(u[0]), engine="ref").numpy(),
                                  np.asarray(want[0]))
    codes = np.where(u < np.asarray(jq.binarize_prob(d_sel, b_sel)), 1, -1).astype(np.int8)
    np.testing.assert_array_equal(got[:, : (k + 7) // 8].numpy(),
                                  np.stack([np.asarray(jq.pack_bits(c)) for c in codes]))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel_wire"])
def test_sparse_wire_against_reference(use_kernels):
    """The compressor's SparseWire under error feedback (d = 700, 10%,
    k = 70 not a multiple of 8, tied magnitudes): indices, packed codes and
    residuals exact against the jitted reference, and the estimate; the
    wire's bytes are wire_bytes' topk price. A weighted estimate of a
    sparse wire raises, as in the reference."""
    m, d = 6, 700
    x = _tied(np.random.default_rng(1), m, d)
    res0 = (0.001 * np.random.default_rng(2).standard_normal((m, d))).astype(np.float32)
    jp = jbuild("probit_plus", topk_frac=0.1, error_feedback=True, use_kernels=use_kernels, chunk=256)
    tp = build_pipeline("probit_plus", topk_frac=0.1, error_feedback=True, use_kernels=use_kernels, chunk=256)
    jw, jres = jax.jit(lambda kk, x, r: jp.compress_wire(kk, x, jnp.float32(0.3), r))(
        jax.random.PRNGKey(5), x, res0)
    tw, tres = tp.compress_wire(prng.key(5), _t(x), torch.tensor(0.3), _t(res0))
    assert isinstance(tw, SparseWire) and tw.k == 70
    np.testing.assert_array_equal(tw.indices.numpy(), np.asarray(jw.indices))
    np.testing.assert_array_equal(tw.packed.numpy(), np.asarray(jw.packed))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(tp.estimate(tw).numpy(), np.asarray(jax.jit(jp.estimate)(jw)))
    assert 4 * tw.indices.numel() + tw.packed.numel() == m * wire_bytes(d, topk_frac=0.1) == m * (4 * 70 + 9)
    with pytest.raises(TypeError, match="dense PackedWire"):
        tp.estimate(tw, torch.ones(m))


def test_flsimulation_topk_kernel_wire_against_reference():
    """Two rounds of ``topk_frac=0.1`` on the kernel wire (its plain
    version here) with error feedback and 25% bit_flip Byzantines, held to
    the reference's FLSimulation with _hold's bars."""
    _hold(*_both(topk_frac=0.1, use_kernels=True, error_feedback=True, byz_frac=0.25, attack="bit_flip"))


def test_topk_refused_where_the_reference_refuses():
    """Top-k under DP, streamed or asynchronous: the reference's messages."""
    for kw, match in ((dict(dp_epsilon=0.1), "index set"), (dict(client_chunk=2), "SparseWire"),
                      (dict(async_buffer=2), "SparseWire"), (dict(wire_bits=2), "top-k wire")):
        with pytest.raises(ValueError, match=match):
            FLConfig(n_clients=4, topk_frac=0.5, **kw)
