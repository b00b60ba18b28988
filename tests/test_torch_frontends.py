"""The port's audio and vision frontends and the encoder-only head
(repro_torch.models.model) against the reference's (repro.models.model)
on the CPU: the reduced hubert (30% of its frames masked) and the reduced
pixtral (16 patches before the tokens).

- ``_embed_inputs``: hubert's frames with the mask token, its positions,
  labels and mask, bit for bit; pixtral's mask and padded labels bit for
  bit, its projected patches within rtol 1e-6 and 1e-6 of the largest
  (measured 2.3e-7 of it: the f32 einsum sums in another order), its
  token embeddings bit for bit.
- The losses' masks, the reference's rules: hubert's loss reads only the
  masked frames' labels; pixtral's reads no patch position and, after the
  roll, not the first text label (the last patch would predict it).
- ``sample_batch`` draws frames, labels and mask, or patches, tokens and
  labels, in the reference's order; the trainer's round batch carries the
  reference trainer's stubs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import build_specs as jbs
from repro.models import init_params as jip
from repro.models import model as jm
from repro.models import sample_batch as jsample
from repro.models import train_loss as jloss
from repro_torch import configs as tc
from repro_torch import tree
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import train
from repro_torch.models import build_specs as tbs
from repro_torch.models import model as tm
from repro_torch.models import sample_batch as tsample
from repro_torch.models import train_loss as tloss

SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Per frontend arch: both reduced configs, the reference's f32 tree as
    numpy, the port's f32 tree carried from it, and a batch of each."""
    out = {}
    for arch in ("hubert-xlarge", "pixtral-12b"):
        jcfg, tcfg = jc.reduced(jc.get_config(arch)), tc.reduced(tc.get_config(arch))
        jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jip(jbs(jcfg), jax.random.PRNGKey(0)))
        tp = lm_params_from_numpy(jp, dtype=torch.float32)
        jb = {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
              for k, v in jsample(jcfg, 2, SEQ, "train", seed=2).items()}
        tb = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in tsample(tcfg, 2, SEQ, "train", seed=2).items()}
        out[arch] = (jcfg, tcfg, jp, tp, jb, tb)
    return out


def test_audio_embed_inputs(models):
    jcfg, tcfg, jp, tp, jb, tb = models["hubert-xlarge"]
    assert 0.2 < float(tb["mask"].float().mean()) < 0.4
    want = jax.jit(lambda p, b: jm._embed_inputs(p, b, jcfg))(jp, jb)
    got = tm._embed_inputs(tp, tb, tcfg)
    for a, c in zip(want, got):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    x = got[0]
    assert torch.equal(x[tb["mask"]], tp["mask_token"].expand(int(tb["mask"].sum()), -1))
    assert torch.equal(x[~tb["mask"]], tb["feats"][~tb["mask"]])


def test_vision_embed_inputs(models):
    jcfg, tcfg, jp, tp, jb, tb = models["pixtral-12b"]
    npatch = tcfg.frontend_tokens
    assert npatch == 16 and tb["patches"].shape == (2, npatch, tcfg.d_model) and tb["tokens"].shape == (2, SEQ - npatch)
    jx, jpos, jlab, jmask = jax.jit(lambda p, b: jm._embed_inputs(p, b, jcfg))(jp, jb)
    x, pos, lab, mask = tm._embed_inputs(tp, tb, tcfg)
    assert x.shape == (2, SEQ, tcfg.d_model)
    jx = np.asarray(jx)
    np.testing.assert_allclose(x[:, :npatch].numpy(), jx[:, :npatch], rtol=1e-6, atol=1e-6 * np.abs(jx).max())
    np.testing.assert_array_equal(x[:, npatch:].numpy(), jx[:, npatch:])
    for a, c in ((jpos, pos), (jlab, lab), (jmask, mask)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    assert not mask[:, :npatch].any() and mask[:, npatch:].all() and not lab[:, :npatch].any()
    # a bf16 patch meets the f32 projector widened, as JAX promotes it
    half = dict(tb, patches=tb["patches"].bfloat16())
    torch.testing.assert_close(tm._embed_inputs(tp, half, tcfg)[0][:, :npatch],
                               torch.einsum("bpd,de->bpe", half["patches"].float(), tp["projector"]), rtol=0, atol=0)


@functools.cache
def _jitted_loss(jcfg):
    return jax.jit(lambda p, b: jloss(p, b, jcfg))


def _loss_pair(jcfg, tcfg, jp, tp, batch):
    return (float(_jitted_loss(jcfg)(jp, batch)),
            float(tloss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)))


def test_loss_masks_are_the_references(models):
    """Moving a label the loss must not read leaves both packages' losses as
    they were; moving one it reads moves both alike."""
    jcfg, tcfg, jp, tp, jb, _ = models["hubert-xlarge"]
    nb = {k: np.array(v) for k, v in jb.items()}
    base = _loss_pair(jcfg, tcfg, jp, tp, nb)
    unmasked, masked = np.argwhere(~nb["mask"])[0], np.argwhere(nb["mask"])[0]
    for where, moves in ((unmasked, False), (masked, True)):
        moved = dict(nb, labels=nb["labels"].copy())
        moved["labels"][tuple(where)] = (moved["labels"][tuple(where)] + 1) % tcfg.vocab
        got = _loss_pair(jcfg, tcfg, jp, tp, moved)
        assert (got[0] != base[0]) == moves and (got[1] != base[1]) == moves
        np.testing.assert_allclose(got[1], got[0], rtol=1e-6)
    jcfg, tcfg, jp, tp, jb, _ = models["pixtral-12b"]
    nb = {k: np.array(v) for k, v in jb.items()}
    base = _loss_pair(jcfg, tcfg, jp, tp, nb)
    for col, moves in ((0, False), (1, True), (-1, True)):
        moved = dict(nb, labels=nb["labels"].copy())
        moved["labels"][0, col] = (moved["labels"][0, col] + 1) % tcfg.vocab
        got = _loss_pair(jcfg, tcfg, jp, tp, moved)
        assert (got[0] != base[0]) == moves and (got[1] != base[1]) == moves, col
        np.testing.assert_allclose(got[1], got[0], rtol=1e-6)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "pixtral-12b"])
def test_prefill_heads(models, arch):
    """hubert's prefill is the classifier's f32 logits over every frame;
    pixtral's the LM head over patches and tokens; both the reference's at
    the f32 bars of test_torch_lm_model.py (atol 2e-3; measured 7.4e-5 and
    3.8e-4)."""
    jcfg, tcfg, jp, tp, jb, tb = models[arch]
    want = np.asarray(jax.jit(lambda p, b: jm.prefill(p, b, jcfg))(jp, jb))
    got = tm.prefill(tp, tb, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, SEQ, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "pixtral-12b"])
def test_sample_batch_order_is_the_references(arch):
    jcfg, tcfg = jc.reduced(jc.get_config(arch)), tc.reduced(tc.get_config(arch))
    for kind in ("train", "prefill", "decode"):
        jb, tb = jsample(jcfg, 3, SEQ, kind, seed=7), tsample(tcfg, 3, SEQ, kind, seed=7)
        assert list(jb) == list(tb)
        for k in jb:
            assert str(tb[k].dtype).removeprefix("torch.") == str(jb[k].dtype)
            np.testing.assert_array_equal(tb[k].float().numpy(), np.asarray(jb[k], np.float32))


@pytest.mark.parametrize("arch", ["hubert-xlarge", "pixtral-12b"])
def test_round_batch_carries_the_reference_trainers_stubs(arch):
    """The reference trainer's stubs (``repro/launch/train.py``): bf16
    patches of 0.02 before the tokens; bf16 frames of 0.02, every one
    masked, labelled ``tokens % vocab``."""
    args = train.parse_args(["--arch", arch, "--reduced", "--device", "cpu", "--clients", "3", "--seq", "16",
                             "--rounds", "2"])
    run = train.setup(args)
    b = train.round_batch(run, args, 1)
    s = np.stack([st[4:8].reshape(2, 2, 17) for st in run.streams])[:, None]
    cfg = run.cfg
    if arch == "pixtral-12b":
        want = {"patches": 0.02 * jnp.ones(s.shape[:4] + (cfg.frontend_tokens, cfg.d_model), jnp.bfloat16),
                "tokens": s[..., :-1], "labels": s[..., 1:]}
    else:
        want = {"feats": 0.02 * jnp.ones(s.shape[:4] + (16, cfg.d_model), jnp.bfloat16),
                "labels": s[..., :-1] % cfg.vocab, "mask": np.ones(s.shape[:4] + (16,), bool)}
    assert sorted(b) == sorted(want)
    for k, v in want.items():
        assert b[k].shape == v.shape and str(b[k].dtype).removeprefix("torch.") == str(v.dtype)
        np.testing.assert_array_equal(b[k].float().numpy(), np.asarray(v, np.float32))
    # the step's cohort and pod sizes come from the batch's first leaf
    assert tree.leaves(b)[0].shape[:2] == (3, 1)
