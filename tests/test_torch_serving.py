"""The port's serving engine (repro_torch.serving) and examples
(repro_torch.examples) on the CPU: the engine's greedy and sampled tokens
against the reference's engine (repro.serving) on the reduced qwen2, the
sampler's draws against jax.random, the port's versions of the reference's
engine tests in tests/test_serving.py, and one smoke run of every example
at its smallest size.

The tokens are compared exactly: greedy is ``argmax`` of the f32 logits
(ties to the first index) and sampling ``argmax(logits * f32(1/T) +
gumbel)`` with the gumbel draws bit for bit; the bf16 model's logits
differ from the reference's by at most ~0.16 (tests/test_torch_decode.py),
and on these prompts no such difference reorders the top two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import build_specs as jbs
from repro.models import init_params as jip
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs as tc
from repro_torch import prng
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import build_specs as tbs
from repro_torch.models import init_params as tip
from repro_torch.models import prefill
from repro_torch.serving import ServeConfig, ServingEngine

ARCH = "qwen2-1.5b"
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]  # 3 requests over a batch of 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    """The reduced qwen2: the port's config and parameters (the port's own
    init, which is the reference's bit for bit)."""
    cfg = tc.reduced(tc.get_config(ARCH))
    return cfg, tip(tbs(cfg), prng.key(0))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_tokens_equal_the_reference_engines(temperature):
    jcfg, tcfg = jc.reduced(jc.get_config(ARCH)), tc.reduced(tc.get_config(ARCH))
    jp = jip(jbs(jcfg), jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    kw = dict(batch_size=2, max_len=32, max_new_tokens=5, temperature=temperature)
    want = JServingEngine(jcfg, jp, JServeConfig(**kw)).generate(PROMPTS, seed=0)
    eng = ServingEngine(tcfg, tp, ServeConfig(**kw))
    got = eng.generate(PROMPTS, seed=0)
    assert got == want
    assert eng.steps == 3 + 5 - 1 + 4 + 5 - 1  # two waves, each to its longest prompt's last token
    assert eng.generate(PROMPTS, seed=0) == got  # repeatable
    if temperature:
        assert eng.generate(PROMPTS, seed=1) != got


def test_sampler_draws_are_jaxs():
    """prng.uniform with a minval, prng.gumbel and prng.categorical against
    jax.random's, and the engine's ``* f32(1/T)`` against the jitted
    ``logits / T`` (XLA multiplies by the f32 reciprocal)."""
    k = jax.random.split(jax.random.PRNGKey(3))[1]
    tk = prng.split(prng.key(3), 2)[1]
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u = jax.jit(lambda k: jax.random.uniform(k, (3, 4099), minval=tiny, maxval=1.0))(k)
    np.testing.assert_array_equal(prng.uniform(tk, (3, 4099), minval=tiny).numpy(), np.asarray(u))
    u2 = jax.random.uniform(k, (4099,), minval=-2.5)
    np.testing.assert_array_equal(prng.uniform(tk, (4099,), minval=-2.5).numpy(), np.asarray(u2))
    g = jax.jit(lambda k: jax.random.gumbel(k, (3, 4099)))(k)
    np.testing.assert_array_equal(prng.gumbel(tk, (3, 4099)).numpy(), np.asarray(g))
    logits = np.random.default_rng(0).standard_normal((3, 4099)).astype(np.float32) * 4
    want = jax.jit(lambda k, l: jax.random.categorical(k, l / 0.8, axis=-1))(k, logits)
    from repro_torch.core.aggregation import recip32

    got = prng.categorical(tk, torch.from_numpy(logits) * recip32(0.8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scaled = jax.jit(lambda l: l / 0.8)(logits)
    np.testing.assert_array_equal((torch.from_numpy(logits) * recip32(0.8)).numpy(), np.asarray(scaled))


def test_greedy_ties_go_to_the_first_index(engine):
    cfg, params = engine
    eng = ServingEngine(cfg, params, ServeConfig(batch_size=2, max_len=8))
    logits = torch.zeros(2, cfg.vocab)
    logits[0, [7, 3, 11]] = 2.0
    logits[1, [400, 5]] = 1.0
    assert torch.argmax(logits, dim=-1).tolist() == [3, 5]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)).tolist() == [3, 5]
    assert eng.step(torch.zeros((2, 1), dtype=torch.long), 0, prng.key(0)).shape == (2,)


def test_engine_refuses_what_it_cannot_serve(engine):
    cfg, params = engine
    eng = ServingEngine(cfg, params, ServeConfig(batch_size=2, max_len=8, max_new_tokens=5))
    with pytest.raises(ValueError, match="positions"):
        eng.generate([[1, 2, 3, 4, 5]])  # 5 + 5 - 1 positions > 8
    ring = ServingEngine(cfg, params, ServeConfig(batch_size=2, max_len=4, max_new_tokens=5, window=4))
    assert len(ring.generate([[1, 2, 3, 4, 5]])[0]) == 5
    hub = tc.reduced(tc.get_config("hubert-xlarge"))
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(hub, params, ServeConfig())


def test_eos_stops_a_slot(engine):
    cfg, params = engine
    eng = ServingEngine(cfg, params, ServeConfig(batch_size=2, max_len=32, max_new_tokens=5))
    full = eng.generate([[1, 2, 3]])[0]
    eos = ServingEngine(cfg, params, ServeConfig(batch_size=2, max_len=32, max_new_tokens=5, eos_token=full[1]))
    assert eos.generate([[1, 2, 3]])[0] == full[: full.index(full[1]) + 1]


# -- the port's versions of tests/test_serving.py's engine tests -------------

def test_batched_generation(engine):
    cfg, params = engine
    eng = ServingEngine(cfg, params, ServeConfig(batch_size=2, max_len=32, max_new_tokens=5))
    out = eng.generate(PROMPTS)
    assert len(out) == 3
    assert all(len(o) == 5 for o in out)
    assert all(0 <= t < cfg.vocab for o in out for t in o)


def test_greedy_matches_prefill_argmax(engine):
    """The first generated token is the argmax of prefill's logits at the
    last prompt position."""
    cfg, params = engine
    eng = ServingEngine(cfg, params, ServeConfig(batch_size=1, max_len=32, max_new_tokens=1))
    prompt = [3, 1, 4, 1, 5]
    out = eng.generate([prompt])
    logits = prefill(params, {"tokens": torch.tensor([prompt])}, cfg)
    assert out[0][0] == int(torch.argmax(logits[0, -1]))


def test_sampled_generation_runs(engine):
    cfg, params = engine
    eng = ServingEngine(cfg, params, ServeConfig(batch_size=2, max_len=32, max_new_tokens=4, temperature=0.8))
    out = eng.generate([[1, 2], [3]])
    assert all(len(o) == 4 for o in out)


def test_ssm_family_serves():
    cfg = tc.reduced(tc.get_config("xlstm-350m"))
    params = tip(tbs(cfg), prng.key(1))
    eng = ServingEngine(cfg, params, ServeConfig(batch_size=2, max_len=16, max_new_tokens=3))
    out = eng.generate([[1, 2, 3]])
    assert len(out[0]) == 3


# -- the examples ------------------------------------------------------------

EXAMPLES = {
    "serve_llm": ["--max-new-tokens", "4"],
    "quickstart": ["--rounds", "1", "--clients", "4"],
    "byzantine_robustness": ["--rounds", "1"],
    "private_federated_lm": ["--rounds", "1", "--eps", "0.1"],
    "train_100m": ["--rounds", "1", "--seq", "16", "--eval-seqs", "2", "--clients", "2", "--ckpt-dir", ""],
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu_when_asked(name, capsys):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = mod.main(EXAMPLES[name] + ["--device", "cpu"])
    assert "CPU" in capsys.readouterr().out
    if name == "serve_llm":
        assert [len(o) for o in out] == [4] * 6
    elif name == "quickstart":
        assert set(out) == {"fedavg", "probit_plus"} and all(0 <= a <= 1 for a in out.values())
    elif name == "byzantine_robustness":
        assert len(out) == 4 and all(len(row) == 3 for row in out.values())
    elif name == "private_federated_lm":
        assert list(out) == ["eps=0.1"] and np.isfinite(out["eps=0.1"]["nll"])
        assert out["eps=0.1"]["eps_spent"] < out["eps=0.1"]["eps_basic"]
    else:
        assert np.isfinite(out["probit_plus"]["history"][0]["loss_last"]) and "fedavg" in out
        assert out["wire"]["wire_bytes_f32"] > 30 * out["wire"]["wire_bytes"]


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.examples import serve_llm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_llm.main([])
