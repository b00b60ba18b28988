"""The port's CNN and ResNet, its nested ravel order, its image data and its
row-blocked uniform draw against the JAX package's, at small sizes.

Logits and gradients are held to rtol 1e-5 (atol 1e-6 on gradients near
zero): the convolutions, reductions and group norms of the two frameworks
sum in other orders. Initial weights, the ravel order, the data and the
uniforms are exact.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import repro  # noqa: E402,F401
from repro.core import quantizer as jq  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro_torch import interop, prng  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402

TINY_BLOCKS = (1, 1, 1, 1)
# (reference init, port init, kwargs, image shape, reference logits, port logits)
MODELS = {
    "cnn": (jv.init_cnn, tv.init_cnn, dict(width=4, img=8), (8, 8, 1), jv.cnn_logits, tv.cnn_logits),
    "cnn_rgb": (jv.init_cnn, tv.init_cnn, dict(in_ch=3, width=4, img=12), (12, 12, 3), jv.cnn_logits,
                tv.cnn_logits),
    "resnet": (jv.init_resnet, tv.init_resnet, dict(width=8, blocks=TINY_BLOCKS), (16, 16, 3),
               functools.partial(jv.resnet_logits, blocks=TINY_BLOCKS),
               functools.partial(tv.resnet_logits, blocks=TINY_BLOCKS)),
    "resnet_2stage": (jv.init_resnet, tv.init_resnet, dict(width=8, blocks=(2, 1)), (16, 16, 3),
                      functools.partial(jv.resnet_logits, blocks=(2, 1)),
                      functools.partial(tv.resnet_logits, blocks=(2, 1))),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed=0):
    """The reference's initial weights with every leaf moved off its init
    (non-zero biases, norm scales off 1), so each gradient slot is tested."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * rng.standard_normal(np.shape(v))).astype(np.float32), tree)


def _images(shape, n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + shape).astype(np.float32), rng.integers(0, 10, n).astype(np.int32)


def _same_tree(got: dict, want: dict):
    """Same nesting and keys at every level, every leaf bit for bit."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _same_tree(got[k], v)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name,seed", [(name, seed) for seed, name in enumerate(MODELS)])
def test_init_is_bit_exact(name, seed):
    """Every leaf of the port's init equals the reference's, the ResNet's
    ``proj`` where a block changes stride or width and nowhere else."""
    jinit, tinit, kw, *_ = MODELS[name]
    jp, tp = jinit(jax.random.PRNGKey(seed), **kw), tinit(prng.key(seed), **kw)
    _same_tree(tp, jp)
    if name.startswith("resnet"):
        assert "proj" in tp["s1b0"] and "proj" not in tp["s0b0"]
        assert all("proj" not in blk for k, blk in tp.items() if k.endswith("b1"))


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_and_gradient_match_reference(name):
    jinit, _, kw, shape, jlogits, tlogits = MODELS[name]
    p = _perturbed(jinit(jax.random.PRNGKey(2), **kw))
    x, y = _images(shape, 5)
    jflat, junravel = ravel_pytree(p)
    jloss = lambda w: jv.xent_loss(jlogits, junravel(w), {"x": x, "y": y})  # noqa: E731
    jl, jg = jax.value_and_grad(jloss)(jflat)
    flat, unravel = interop.ravel_params(p)
    logits = tlogits(unravel(flat), torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits(junravel(jflat), x)), rtol=1e-5, atol=1e-6)
    w = flat.clone().requires_grad_(True)
    tl = tv.xent_loss(tlogits, unravel(w), {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    (tg,) = torch.autograd.grad(tl, w)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("size", [7, 8, 16])
def test_same_convolution_matches_xla(size, k, stride):
    """XLA's SAME padding, asymmetric at stride 2 on even sizes."""
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((3, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = np.asarray(jv._conv(x, w, stride))
    got = tv._conv(tv._cohort_images(torch.from_numpy(x)[None]), torch.from_numpy(w)[None], stride)
    got = got.permute(1, 0, 3, 4, 2)[0].numpy()  # (B, M, O, H, W) -> client 0, NHWC
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [4, 16])
def test_groupnorm_and_pool_match_reference(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 6, 6, c)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    h = tv._cohort_images(torch.from_numpy(x)[None])
    got = tv._groupnorm(h, torch.from_numpy(g)[None], torch.from_numpy(b)[None])
    np.testing.assert_allclose(got.permute(1, 0, 3, 4, 2)[0].numpy(), np.asarray(jv._groupnorm(x, g, b)),
                               rtol=1e-5, atol=1e-6)
    pooled = tv._pool(h).permute(1, 0, 3, 4, 2)[0].numpy()
    np.testing.assert_array_equal(pooled, np.asarray(jv._pool(x)))


@pytest.mark.parametrize("name", list(MODELS))
def test_cohort_model_equals_loop_over_clients(name):
    """One grouped convolution a layer for 3 clients equals each client's
    own model on its own images (rtol 1e-5: the grouped and single
    convolutions may sum in other orders)."""
    jinit, _, kw, shape, _, tlogits = MODELS[name]
    flat, unravel = interop.ravel_params(_perturbed(jinit(jax.random.PRNGKey(4), **kw)))
    ws = torch.stack([flat, 0.9 * flat, 1.1 * flat])
    xs, ys = zip(*(_images(shape, 4, seed=s) for s in range(3)))
    batch = {"x": torch.from_numpy(np.stack(xs)), "y": torch.from_numpy(np.stack(ys))}
    losses = tv.xent_loss(tlogits, unravel(ws), batch)
    logits = tlogits(unravel(ws), batch["x"])
    assert losses.shape == (3,) and logits.shape == (3, 4, 10)
    for i in range(3):
        one = {"x": batch["x"][i], "y": batch["y"][i]}
        np.testing.assert_allclose(logits[i].numpy(), tlogits(unravel(ws[i]), one["x"]).numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(losses[i].item(), tv.xent_loss(tlogits, unravel(ws[i]), one).item(), rtol=1e-5)
    acc = tv.accuracy(tlogits, unravel(ws), batch)
    assert acc.shape == (3,) and bool(((acc >= 0) & (acc <= 1)).all())


def test_nested_ravel_order_and_round_trip():
    p = _numpy_tree(jv.init_resnet(jax.random.PRNGKey(0), width=8, blocks=TINY_BLOCKS))
    jflat, junravel = ravel_pytree(p)
    flat, unravel = interop.ravel_params(p)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(interop.params_from_jax(p).numpy(), np.asarray(jflat))
    # a marker at each coordinate lands on the same leaf and slot as in the reference
    marks = np.arange(flat.numel(), dtype=np.float32)
    jtree, ttree = junravel(jnp.asarray(marks)), unravel(torch.from_numpy(marks))
    jleaves = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(jleaves) == sum(1 for _ in interop._leaves(ttree))
    for path, leaf in jleaves:
        node = ttree
        for part in path:
            node = node[part.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    cohort = unravel(torch.stack([flat, 2 * flat]))
    np.testing.assert_array_equal(cohort["s1b0"]["proj"][1].numpy(), 2 * p["s1b0"]["proj"])
    assert cohort["s1b0"]["proj"].data_ptr() != 0 and cohort["stem"].shape == (2,) + p["stem"].shape


def set_block_rows(monkeypatch, rows: int, n: int) -> None:
    """Make the uniform draw take ``rows`` client rows a block at ``n``
    coordinates a row."""
    monkeypatch.setattr(tq, "UNIFORM_BLOCK_WORDS", rows * tq.padded_dim(n))
    assert tq.uniform_block_rows(tq.padded_dim(n)) == rows


@pytest.mark.parametrize("m,block", [(7, 3), (7, 1), (10, 4), (5, 64)])
def test_row_blocked_uniforms_equal_unblocked(m, block, monkeypatch):
    """The uniforms drawn ``block`` client rows at a time (a block that need
    not divide M) equal the whole cohort's draw, which
    tests/test_torch_quantizer.py holds to the reference's."""
    key, n = prng.key(11), 20_000
    rows = 3 + torch.arange(m)
    whole = tq.client_uniforms(prng.fold_in(key, rows), n)
    set_block_rows(monkeypatch, block, n)
    blocked = tq.cohort_uniforms(key, m, n, row_offset=3)
    assert torch.equal(blocked.view(torch.int32), whole.view(torch.int32))
    out = torch.full((m, n + 24), 7.0)
    tq.cohort_uniforms(key, m, n, row_offset=3, out=out)
    assert torch.equal(out[:, :n], whole) and bool((out[:, n:] == 7.0).all())


@pytest.mark.parametrize("want_residual", [False, True])
@pytest.mark.parametrize("block", [1, 3])
def test_row_blocked_compression_equals_reference(block, want_residual, monkeypatch):
    """packed_binarize_batch compresses the cohort ``block`` rows at a
    time: wire and residuals equal the reference's whole-cohort result."""
    m, d = 7, 10_001
    set_block_rows(monkeypatch, block, d)
    rng = np.random.default_rng(block)
    deltas = (0.01 * rng.standard_normal((m, d))).astype(np.float32)
    b = np.float32(0.012)
    jp, jr = jq.packed_binarize_batch(jax.random.PRNGKey(6), deltas, b, want_residual=want_residual, row_offset=2)
    tp, tr = tq.packed_binarize_batch(prng.key(6), torch.from_numpy(deltas), torch.tensor(b),
                                      want_residual=want_residual, row_offset=2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    if want_residual:
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    else:
        assert tr is None


def test_uniform_block_rows_bound_the_threefry_temporaries():
    assert tq.uniform_block_rows(tq.padded_dim(118_282)) >= 100  # the MLP's cohort in one block
    rows = tq.uniform_block_rows(tq.padded_dim(11_172_042))
    assert rows == 12 and rows * tq.padded_dim(11_172_042) * 8 <= (1 << 30)
    assert tq.uniform_block_rows(1 << 40) == 1


def test_kernel_wire_inputs_are_padded_buffers(monkeypatch):
    """The kernel engine's padded inputs (uniforms with pad 1.0, deltas with
    pad -1) equal F.pad of the whole-cohort arrays they replace."""
    m, d = 5, 3_001
    set_block_rows(monkeypatch, 2, d)
    width = ops.padded_len(d)
    deltas = torch.from_numpy(np.random.default_rng(0).standard_normal((m, d)).astype(np.float32))
    padded = tq.pad_rows(deltas, width, -1.0)
    assert torch.equal(padded, torch.nn.functional.pad(deltas, (0, width - d), value=-1.0))
    u = torch.empty((m, width))
    u[:, d:] = 1.0
    tq.cohort_uniforms(prng.key(2), m, d, out=u)
    whole = tq.client_uniforms(prng.fold_in(prng.key(2), torch.arange(m)), d)
    assert torch.equal(u, torch.nn.functional.pad(whole, (0, width - d), value=1.0))


def test_image_data_matches_reference():
    from repro.data import make_image_classification as j_make
    from repro_torch.data import make_image_classification as t_make

    for kw in ({"img": 8}, {"img": 16, "channels": 3, "n_classes": 4}):
        (jx, jy), (jxt, jyt) = j_make(5, n_train=64, n_test=16, **kw)
        (tx, ty), (txt, tyt) = t_make(5, n_train=64, n_test=16, **kw)
        assert tx.shape == (64, kw["img"], kw["img"], kw.get("channels", 1)) and tx.dtype == np.float32
        for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
            np.testing.assert_array_equal(a, b)


def test_model_registry_matches_reference():
    assert sorted(tv.MODELS) == sorted(jv.MODELS)
    assert tv.MODELS["cnn"] == (tv.init_cnn, tv.cnn_logits)
    assert tv.MODELS["resnet"] == (tv.init_resnet, tv.resnet_logits)
