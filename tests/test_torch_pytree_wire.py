"""The port's per-leaf wire (repro_torch.fl.pytree_wire) against the
reference's (repro.fl.pytree_wire) on the same deltas, bit for bit: the
one-shot and the client-streamed rounds of the three count schemes, leaves
of size % 8 != 0, error feedback over two rounds, top-k, exact counts past
255 clients at 32 and 16 bits, the kernel wire, weights and the byte
report. Mirrors tests/test_pytree_wire.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_pipeline as jbuild
from repro.fl import pytree_wire as jpw
from repro_torch import prng, tree
from repro_torch.core import build_pipeline as tbuild
from repro_torch.fl import pytree_wire as tpw

M = 6
B = np.float32(0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(seed, m=M):
    """Deltas over a small tree with a list in it: the (7,) leaf has size % 8
    != 0 and the (4, 5) leaf size % 8 == 4, so pad bits are sliced off."""
    rng = np.random.default_rng(seed)
    return {
        "w": (0.02 * rng.standard_normal((m, 4, 5))).astype(np.float32),
        "bias": (0.02 * rng.standard_normal((m, 7))).astype(np.float32),
        "blocks": [{"v": (0.02 * rng.standard_normal((m, 2, 8))).astype(np.float32)}],
    }


def both(tree_np):
    return jax.tree.map(jnp.asarray, tree_np), tree.tree_map(torch.from_numpy, tree_np)


def params_like(t):
    return tree.tree_map(lambda x: x[0], t)


def assert_trees_equal(jt, tt):
    jl, tl = jax.tree.leaves(jt), tree.leaves(tt)
    assert len(jl) == len(tl)
    for a, c in zip(jl, tl):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))


def run_both(name, seed, **kw):
    """One tree, the pipeline ``name`` and a zero state, in both packages."""
    jd, td = both(make_tree(seed))
    jp, tp = jbuild(name, **kw), tbuild(name, **kw)
    js, ts = jpw.init_wire_state(params_like(jd), M), tpw.init_wire_state(params_like(td), M)
    return jd, td, jp, tp, js, ts


@functools.cache
def reference_round(scheme):
    """The reference's one-shot round of ``scheme`` on tree 0, once for
    both client chunks."""
    jd, _, jp, _, js, _ = run_both(scheme, 0)
    return jpw.aggregate_pytree(jp, jax.random.PRNGKey(42), jd, jnp.float32(B), js)


@pytest.mark.parametrize("scheme", ["probit_plus", "signsgd_mv", "rsa"])
@pytest.mark.parametrize("client_chunk", [2, 3])
def test_stream_equals_oneshot_and_reference(scheme, client_chunk):
    """Streamed == one-shot in the port, and both == the reference's."""
    _, td, _, tp, _, ts = run_both(scheme, 0)
    jt, jst = reference_round(scheme)
    t1, s1 = tpw.aggregate_pytree(tp, prng.key(42), td, torch.tensor(B), ts)
    t2, s2 = tpw.stream_aggregate_pytree(tp, prng.key(42), td, torch.tensor(B), ts, client_chunk=client_chunk)
    assert_trees_equal(jt, t1)
    assert_trees_equal(jt, t2)
    assert_trees_equal(jst.residuals, s1.residuals)
    assert_trees_equal(jst.residuals, s2.residuals)


@pytest.mark.parametrize("rand_bits", [32, 16])
def test_wires_and_thetas_equal_reference(rand_bits):
    """Every leaf's packed wire and theta equal the reference's, at both
    draw widths (a 16-bit round is another bit stream than a 32-bit one)."""
    jd, td, jp, tp, js, ts = run_both("probit_plus", 1, rand_bits=rand_bits)
    jw, _ = jpw.compress_pytree(jp, jax.random.PRNGKey(7), jd, jnp.float32(B), js)
    tw, _ = tpw.compress_pytree(tp, prng.key(7), td, torch.tensor(B), ts)
    for a, c in zip(jw, tw):
        np.testing.assert_array_equal(c.packed.numpy(), np.asarray(a.packed))
    jt, _ = jpw.aggregate_pytree(jp, jax.random.PRNGKey(7), jd, jnp.float32(B), js)
    tt, _ = tpw.aggregate_pytree(tp, prng.key(7), td, torch.tensor(B), ts)
    assert_trees_equal(jt, tt)
    t32, _ = tpw.aggregate_pytree(tbuild("probit_plus"), prng.key(7), td, torch.tensor(B), ts)
    if rand_bits == 16:
        assert any(not torch.equal(a, c) for a, c in zip(tree.leaves(tt), tree.leaves(t32)))


def test_ef_carryover_two_rounds():
    """EF residuals advance as the reference's over two rounds, one-shot and
    streamed, and carry mass."""
    jp, tp = jbuild("probit_plus", error_feedback=True), tbuild("probit_plus", error_feedback=True)
    jd0, td0 = both(make_tree(2))
    js, ts = jpw.init_wire_state(params_like(jd0), M), tpw.init_wire_state(params_like(td0), M)
    ts2 = ts
    for r in range(2):
        jd, td = both(make_tree(10 + r))
        jk = jax.random.fold_in(jax.random.PRNGKey(5), r)
        tk = prng.fold_in(prng.key(5), r)
        jt, js = jpw.aggregate_pytree(jp, jk, jd, jnp.float32(B), js)
        tt, ts = tpw.aggregate_pytree(tp, tk, td, torch.tensor(B), ts)
        tt2, ts2 = tpw.stream_aggregate_pytree(tp, tk, td, torch.tensor(B), ts2, client_chunk=2)
        assert_trees_equal(jt, tt)
        assert_trees_equal(jt, tt2)
        assert_trees_equal(js.residuals, ts.residuals)
        assert_trees_equal(js.residuals, ts2.residuals)
    assert max(float(x.abs().max()) for x in tree.leaves(ts.residuals)) > 0


def test_topk_matches_reference_and_refuses_streaming():
    jd, td, jp, tp, js, ts = run_both("probit_plus", 3, topk_frac=0.5)
    # jitted: one program, not an eager compile of each top-k op (same bits)
    jt, _ = jax.jit(lambda k, d, b, s: jpw.aggregate_pytree(jp, k, d, b, s))(jax.random.PRNGKey(9), jd,
                                                                             jnp.float32(B), js)
    tt, _ = tpw.aggregate_pytree(tp, prng.key(9), td, torch.tensor(B), ts)
    assert_trees_equal(jt, tt)
    with pytest.raises(ValueError, match="top-k"):
        tpw.stream_aggregate_pytree(tp, prng.key(9), td, torch.tensor(B), ts, client_chunk=2)


def test_kernel_wire_equals_chunked_wire():
    """The kernel wire (the plain engine on the CPU) gives the chunked
    wire's thetas, and its rows realign to the chunked wire's bytes."""
    _, td = both(make_tree(4))
    ts = tpw.init_wire_state(params_like(td), M)
    pure, kern = tbuild("probit_plus"), tbuild("probit_plus", use_kernels=True)
    tp_, _ = tpw.aggregate_pytree(pure, prng.key(11), td, torch.tensor(B), ts)
    tk_, _ = tpw.aggregate_pytree(kern, prng.key(11), td, torch.tensor(B), ts)
    for a, c in zip(tree.leaves(tp_), tree.leaves(tk_)):
        assert torch.equal(a, c)
    wp, _ = tpw.compress_pytree(pure, prng.key(11), td, torch.tensor(B), ts)
    wk, _ = tpw.compress_pytree(kern, prng.key(11), td, torch.tensor(B), ts)
    for a, c in zip(wp, wk):
        n = min(a.packed.shape[1], c.packed.shape[1])
        assert torch.equal(a.packed[:, :n], c.packed[:, :n])
        assert not a.packed[:, n:].any() and not c.packed[:, n:].any()


@pytest.mark.parametrize("rand_bits", [32, 16])
def test_counts_exact_past_255_clients(rand_bits):
    """M = 300 saturated clients all vote a certain +1: theta is exactly +b
    in both packages (a uint8 count would wrap to 44), on one leaf of 9
    coordinates (9 % 8 != 0)."""
    m = 300
    deltas = {"w": np.ones((m, 3, 3), np.float32)}
    jd, td = both(deltas)
    jp, tp = jbuild("probit_plus", rand_bits=rand_bits), tbuild("probit_plus", rand_bits=rand_bits)
    jt, _ = jpw.aggregate_pytree(jp, jax.random.PRNGKey(0), jd, jnp.float32(0.5),
                                 jpw.init_wire_state(params_like(jd), m))
    tt, _ = tpw.aggregate_pytree(tp, prng.key(0), td, torch.tensor(np.float32(0.5)),
                                 tpw.init_wire_state(params_like(td), m))
    assert_trees_equal(jt, tt)
    for leaf in tree.leaves(tt):
        assert torch.equal(leaf, torch.full(leaf.shape, 0.5))


def test_weighted_counts_match_unweighted_at_unit_weights():
    _, td = both(make_tree(6))
    tp = tbuild("probit_plus")
    ts = tpw.init_wire_state(params_like(td), M)
    t0, _ = tpw.aggregate_pytree(tp, prng.key(13), td, torch.tensor(B), ts)
    t1, _ = tpw.aggregate_pytree(tp, prng.key(13), td, torch.tensor(B), ts, weights=torch.ones(M))
    for a, c in zip(tree.leaves(t0), tree.leaves(t1)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("kw", [{}, {"rand_bits": 16}, {"topk_frac": 0.5}, {"error_feedback": True}])
def test_wire_bytes_report_equals_reference(kw):
    """The byte report equals the reference's on the chunked wire; ideal
    bytes are ceil(d/8) a leaf; dense pipelines ship f32; the kernel wire
    pads less (1,024- rather than 8,192-coordinate rows)."""
    jd, td = both(make_tree(8))
    want = jpw.pytree_wire_bytes(jbuild("probit_plus", **kw), params_like(jd), M)
    assert tpw.pytree_wire_bytes(tbuild("probit_plus", **kw), params_like(td), M) == want
    d_total = 4 * 5 + 7 + 2 * 8
    assert want["wire_bytes_int8"] == M * d_total and want["wire_bytes_f32"] == M * 4 * d_total
    if not kw:
        assert want["wire_bytes_ideal"] == M * sum((d + 7) // 8 for d in (20, 7, 16))
        kern = tpw.pytree_wire_bytes(tbuild("probit_plus", use_kernels=True), params_like(td), M)
        assert kern["wire_bytes"] == M * 3 * 128 < want["wire_bytes"]
    dense = tpw.pytree_wire_bytes(tbuild("fedavg"), params_like(td), M)
    assert dense == jpw.pytree_wire_bytes(jbuild("fedavg"), params_like(jd), M)
    assert dense["wire_bytes"] == M * 4 * d_total


def test_stream_refuses_what_cannot_stream():
    _, td = both(make_tree(5))
    ts = tpw.init_wire_state(params_like(td), M)
    with pytest.raises(ValueError, match="cannot client-stream"):
        tpw.stream_aggregate_pytree(tbuild("fedavg"), prng.key(0), td, torch.tensor(B), ts, client_chunk=2)
    with pytest.raises(ValueError, match="not divisible"):
        tpw.stream_aggregate_pytree(tbuild("probit_plus"), prng.key(0), td, torch.tensor(B), ts, client_chunk=4)


def test_leaf_key_is_the_reference_schedule():
    for i in (0, 1, 14):
        np.testing.assert_array_equal(tpw.leaf_key(prng.key(3), i).numpy(),
                                      np.asarray(jpw.leaf_key(jax.random.PRNGKey(3), i)))


@pytest.mark.parametrize("rand_bits", [32, 16])
def test_long_rows_are_drawn_in_column_blocks(rand_bits, monkeypatch):
    """A row wider than the draw block (qwen2-1.5b's stacked FFN leaf is
    one row of 385M) is drawn in chunk-aligned column blocks, one of them
    ragged: the wire, the residuals and the uniforms equal the whole draw
    and the reference's."""
    from repro.core import quantizer as jq
    from repro_torch.core import quantizer as tq

    m, d = 2, 4 * tq.PACK_CHUNK + 123
    rng = np.random.default_rng(rand_bits)
    deltas = (0.01 * rng.standard_normal((m, d))).astype(np.float32)
    deltas[0, :50] = 1.0
    jp, jr = jq.packed_binarize_batch(jax.random.PRNGKey(6), deltas, B, want_residual=True, row_offset=3,
                                      rand_bits=rand_bits)
    whole = tq.cohort_uniforms(prng.key(6), m, d, row_offset=3)
    monkeypatch.setattr(tq, "UNIFORM_BLOCK_WORDS", 2 * tq.PACK_CHUNK)
    assert list(tq.draw_blocks(1, tq.padded_dim(d)))[-1] == (0, 1, 4 * tq.PACK_CHUNK, 5 * tq.PACK_CHUNK)
    tp, tr = tq.packed_binarize_batch(prng.key(6), torch.from_numpy(deltas), torch.tensor(B), want_residual=True,
                                      row_offset=3, rand_bits=rand_bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert torch.equal(tq.cohort_uniforms(prng.key(6), m, d, row_offset=3).view(torch.int32), whole.view(torch.int32))
    np.testing.assert_array_equal(tq.packed_residuals(tp, torch.from_numpy(deltas), torch.tensor(B)).numpy(),
                                  np.asarray(jq.packed_residuals(jp, deltas, B)))
