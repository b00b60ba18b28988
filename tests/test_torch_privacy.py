"""The port's privacy helpers and ledger (host-side numpy copies) and its
b-controller against the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402,F401
from repro.core import bcontrol as jb, ledger as jl, privacy as jp  # noqa: E402
from repro_torch.core import bcontrol as tb, ledger as tl, privacy as tp  # noqa: E402


@pytest.mark.parametrize("accountant", tl.ACCOUNTANTS)
@pytest.mark.parametrize("eps,q", [(0.1, 1.0), (0.5, 0.3), (0.0, 1.0)])
def test_ledger_matches_reference(accountant, eps, q):
    j, t = jl.PrivacyLedger(eps, q, accountant), tl.PrivacyLedger(eps, q, accountant)
    for _ in range(7):
        j.record_round()
        t.record_round()
    assert t.eps_spent == j.eps_spent and t.delta_spent == j.delta_spent
    np.testing.assert_array_equal(t.trajectory(), j.trajectory())


def test_composition_helpers_match_reference():
    assert tp.advanced_composition(0.1, 50) == jp.advanced_composition(0.1, 50)
    assert tp.basic_composition(0.1, 50) == jp.basic_composition(0.1, 50)
    assert tp.rounds_for_budget(2.0, 0.1) == jp.rounds_for_budget(2.0, 0.1)
    cfg = tp.DPConfig(0.5, 2e-4)
    assert tp.dp_b_floor(0.01, cfg) == float(jp.dp_b_floor(0.01, jp.DPConfig(0.5, 2e-4)))


@pytest.mark.parametrize("mode", ["dynamic", "fixed"])
def test_b_controller_matches_reference(mode):
    """Strict '<' for the loss bit, a tied vote moves b down, f32 factors."""
    before = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    afters = [np.array([0.5, 2.0, 3.5, 3.0], np.float32),  # +1 -1 -1 +1: tie -> down
              np.array([0.5, 1.0, 2.5, 3.0], np.float32)]  # all +1 -> up
    jcfg, tcfg = jb.BControlConfig(mode), tb.BControlConfig(mode)
    js, ts = jb.init_b_state(jcfg), tb.init_b_state(tcfg)
    for after in afters:
        jbits = jb.loss_bit(before, after)
        tbits = tb.loss_bit(torch.from_numpy(before), torch.from_numpy(after))
        np.testing.assert_array_equal(np.asarray(jbits), tbits.numpy())
        js = jax.jit(lambda s, b: jb.update_b(s, b, jcfg))(js, jbits)
        ts = tb.update_b(ts, tbits, tcfg)
        assert np.float32(js.b) == ts.b.item()
        assert float(js.prev_vote) == ts.prev_vote.item()
