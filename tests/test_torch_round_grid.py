"""The port's round against the JAX package's on the paper's image models,
and over the grid of every aggregator, attack, b mode and participation.

Split from ``tests/test_torch_round.py`` (whose task and simulations these
tests share) so that a run of the suite with one file to a worker runs them
beside that file's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.fl import FLConfig as JConfig  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulation  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from test_torch_round import N_CLIENTS, _one_torch_thread, _sims, _task  # noqa: E402,F401


# (model, config, share of w_global coordinates allowed to differ by a
# flipped wire bit, loss rtol of each round); the CNN's EF wire is held by
# the stage test. Measured on a CPU (the same at 1 and 3 torch threads):
# the CNN flips no bit and meets rtol 1e-6; the ResNet flips 0.041% of the
# coordinates, all in round 3, and its round-3 loss is off by 7.6e-4.
# Client 1 of this cohort sits at loss ln 2 (its two classes unseparated),
# where the reference itself turns a 1-ulp perturbation of the client's
# start into a 1e-5 weight change in one round and into ~1e-3 in the next;
# so rounds 1 and 2 are held to 1e-4 and round 3 to 2e-3, and the flip
# share to 0.1% (each about 2.5 times what was measured).
VISION_CASES = {
    "cnn": ("cnn", {}, 0.001, (1e-4, 1e-4, 1e-4)),
    "resnet": ("resnet", {}, 0.001, (1e-4, 1e-4, 2e-3)),
}


@pytest.mark.parametrize("case", list(VISION_CASES))
def test_flsimulation_end_to_end_vision(case):
    """Three PRoBit+ rounds of both simulations on the paper's image models
    at tiny widths (the bar of test_flsimulation_end_to_end): b exact in
    every round, the loss of each round within its rtol, and every
    coordinate of w_global either within 1e-5 or off by exactly one flipped
    bit, 2b/M at some round's b."""
    model, kw, flip_share, rtols = VISION_CASES[case]
    js, ts = _sims(model, **kw)
    jh = js.run(eval_every=1)
    th = ts.run(eval_every=1)
    assert [h["b"] for h in jh] == [h["b"] for h in th]
    for t, (j, h, rtol) in enumerate(zip(jh, th, rtols)):
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=rtol, err_msg=f"round {t + 1}")
    assert 0.0 <= th[-1]["acc"] <= 1.0
    diff = np.abs(np.asarray(js.w_global) - ts.w_global.numpy())
    bad = diff > 1e-5
    assert bad.sum() <= flip_share * diff.size
    flips = np.array([2 * h["b"] / N_CLIENTS for h in [{"b": 0.01}] + th[:-1]])
    for v in diff[bad]:
        assert np.min(np.abs(v - flips)) <= 1e-6, v


GRID_AGGREGATORS = ("probit_plus", "fedavg", "fed_gm", "signsgd_mv", "rsa")
GRID_ATTACKS = ("none", "gaussian", "sign_flip", "zero_gradient", "sample_duplicate", "alie", "ipm", "bit_flip")


@pytest.mark.parametrize("attack", GRID_ATTACKS)
@pytest.mark.parametrize("aggregator", GRID_AGGREGATORS)
def test_every_aggregator_attack_b_mode_and_participation_runs(aggregator, attack):
    """Each (aggregator, attack) pair under every b_mode, at full and at
    half participation: the reference accepts the config and builds its
    pipeline, and the port runs a round of it to a finite loss and a theta
    of the model's width (a third of each cohort Byzantine)."""
    p0, cx, cy, test = _task()
    for b_mode in ("dynamic", "fixed", "oracle"):
        for participation in (0.5, 1.0):
            kw = dict(n_clients=N_CLIENTS, aggregator=aggregator, attack=attack, byz_frac=0.34, b_mode=b_mode,
                      participation=participation, rounds=1, local_epochs=1)
            JConfig(**kw).pipeline()
            ts = FLSimulation(FLConfig(**kw), p0, functools.partial(tv.xent_loss, tv.mlp_logits),
                              functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")
            (_, met), = ts.iter_rounds()
            assert np.isfinite(met["loss"].item()) and met["theta"].shape == (ts.d,), kw
            assert bool(torch.isfinite(met["theta"]).all()), kw
