"""The port's MoE FFN (repro_torch.models.moe) against the reference's
(repro.models.moe, its no-mesh branch) on the CPU, at the reduced
qwen3-moe (4 experts, top-2, d_model 256, expert width 128) and the
reduced llama4-scout (top-1 with the shared expert), 2 x 64 tokens.

Tolerances, as measured on this CPU:
- routing: the expert indices and each expert's capacity picks exact at
  f32 (the router logits agree to an ulp; no pair of them is that close
  on these inputs), the gates within 1e-6 absolute (measured 1.9e-7: the
  softmax's exp and sum round differently);
- f32 parameters: the block's output within 1e-5 absolute of outputs up to
  ~4 (measured <= 7.2e-7; the products run in another order); every
  leaf's gradient within rtol 1e-4 and 1e-5 of its largest entry
  (measured <= 4.3e-7 of it);
- bf16 parameters: within 0.0625 absolute (two bf16 ulps at 4) and 0.004
  on average (measured <= 0.047 and 2.7e-3: every product rounds to bf16
  and XLA rounds other intermediates than torch);
- the load-balance loss within rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import moe as jm
from repro.models.spec import init_params as jip
from repro_torch import configs as tc
from repro_torch import prng, tree
from repro_torch.models import moe as tm
from repro_torch.models.spec import init_params as tip

B, S = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, **kw):
    return (dataclasses.replace(jc.reduced(jc.get_config(arch)), **kw),
            dataclasses.replace(tc.reduced(tc.get_config(arch)), **kw))


@pytest.fixture(scope="module")
def experts():
    """Per arch: both FFN parameter trees (one layer, the reference's init)
    and a batch of activations."""
    out = {}
    for arch in ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"):
        jcfg, tcfg = cfgs(arch)
        jp, tp = jip(jm.moe_specs(jcfg), jax.random.PRNGKey(3)), tip(tm.moe_specs(tcfg), prng.key(3))
        x = np.random.default_rng(1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        out[arch] = (jp, tp, x)
    return out


def _f32(jp, tp):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jp), tree.tree_map(lambda a: a.float(), tp)


def test_specs_and_init_match_with_an_f32_router(experts):
    for arch, (jp, tp, _) in experts.items():
        jl, tl = jax.tree_util.tree_leaves_with_path(jp), tree.leaves_with_path(tp)
        assert [tree.keystr(p) for p, _ in tl] == ["/".join(str(k) for k in p) for p, _ in jl]
        for (path, a), (_, c) in zip(jl, tl):
            assert c.dtype == (torch.float32 if path[-1].key == "router" else torch.bfloat16)
            assert a.dtype == (jnp.float32 if path[-1].key == "router" else jnp.bfloat16)
            np.testing.assert_array_equal(c.float().numpy(), np.asarray(a, np.float32))
        assert ("sw1" in tp) == (arch == "llama4-scout-17b-a16e")


@pytest.mark.parametrize("tokens,cf,want", [(256, 1.25, 20), (128, 1.25, 10), (128, 0.5, 8), (4000, 0.5, 125),
                                            (6, 1.25, 6), (1000, 1.3, 81)])
def test_capacity_is_the_references(tokens, cf, want):
    """``min(max(int(T * top_k / E * cf), 8), T)``: 20 slots an expert at
    Qwen3-30B-A3B's full width with 2 x 128 tokens, so tokens drop there."""
    full = dataclasses.replace(tc.get_config("qwen3-moe-30b-a3b"), capacity_factor=cf)
    assert tm.capacity(tokens, full) == want
    assert want == min(max(int(tokens * 8 / 128 * cf), 8), tokens)


def _reference_picks(gates, idx, n_experts, cap):
    """The reference's per-expert slot choice, expert by expert."""
    sel, picks = [], []
    for e in range(n_experts):
        gate_e = jnp.sum(jnp.where(idx == e, gates, 0.0), axis=-1)
        top_score, top_idx = jax.lax.top_k(jnp.where(gate_e > 0, gate_e, -1.0), cap)
        sel.append(np.asarray(jnp.maximum(top_score, 0.0)))
        picks.append(np.asarray(top_idx))
    return np.stack(sel), np.stack(picks)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_routing_and_capacity_picks_exact_at_f32(experts, cf):
    """The expert indices and every expert's slots equal the reference's;
    at capacity factor 0.5 tokens are dropped (an expert is routed more
    tokens than it has slots)."""
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b", capacity_factor=cf)
    jp, tp, x = experts["qwen3-moe-30b-a3b"]
    x2d = x.reshape(B * S, -1)
    jg, ji = jax.jit(jm._route, static_argnums=2)(x2d, jp["router"], jcfg.top_k)
    tg, ti = tm._route(torch.from_numpy(x2d), tp["router"], tcfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    cap = tm.capacity(B * S, tcfg)
    want_sel, want_idx = _reference_picks(jg, ji, jcfg.n_experts, cap)
    sel, picks = tm._dispatch(tg, ti, tcfg.n_experts, cap)
    np.testing.assert_array_equal(picks.numpy(), want_idx)
    np.testing.assert_allclose(sel.numpy(), want_sel, rtol=0, atol=1e-6)
    routed = np.bincount(np.asarray(ji).ravel(), minlength=jcfg.n_experts)
    assert (routed > cap).any() == (cf == 0.5)
    # padding slots: gate 0, the lowest-index tokens the expert was not routed
    for e in range(tcfg.n_experts):
        pad = picks[e][sel[e] == 0].numpy()
        unrouted = np.flatnonzero(~(np.asarray(ji) == e).any(-1))
        np.testing.assert_array_equal(pad, unrouted[: len(pad)])


def test_ties_keep_the_lower_index():
    """Equal router logits pick the lower expert first, and equal gates the
    lower token first: two identical router columns and every token
    repeated, at an odd capacity (33 slots) below the routed load, so a
    pair straddles an expert's last slot. Both equal the reference's picks
    and its block's output."""
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b", capacity_factor=33 / 64)
    rng = np.random.default_rng(7)
    router = rng.standard_normal((jcfg.d_model, jcfg.n_experts)).astype(np.float32) * 0.05
    router[:, 2] = router[:, 1]
    x2d = np.repeat(rng.standard_normal((B * S // 2, jcfg.d_model)).astype(np.float32), 2, axis=0)
    jg, ji = jax.jit(jm._route, static_argnums=2)(x2d, router, jcfg.top_k)
    tg, ti = tm._route(torch.from_numpy(x2d), torch.from_numpy(router), tcfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    pairs = np.sort(ti.numpy(), axis=-1)
    both = (pairs == [1, 2]).all(-1)
    assert both.any() and (ti.numpy()[both] == [1, 2]).all()  # the tie: expert 1 before 2
    cap = tm.capacity(B * S, tcfg)
    assert cap == 33
    sel, picks = tm._dispatch(tg, ti, tcfg.n_experts, cap)
    _, want_idx = _reference_picks(jg, ji, jcfg.n_experts, cap)
    np.testing.assert_array_equal(picks.numpy(), want_idx)
    decided = 0
    for e in range(tcfg.n_experts):
        kept = set(picks[e][sel[e] > 0].tolist())
        for t in range(0, B * S, 2):  # tokens t and t + 1 are equal
            if t + 1 in kept:
                assert t in kept
            decided += t in kept and t + 1 not in kept
    assert decided > 0  # some ties were decided by the token index alone
    p = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.1)
         for k, s in (("w1", (4, 256, 128)), ("w3", (4, 256, 128)), ("w2", (4, 128, 256)))}
    p["router"] = jnp.asarray(router)
    want = jax.jit(lambda p, x: jm.moe_block(p, x, jcfg))(p, x2d.reshape(B, S, -1))
    got = tm.moe_block({k: torch.from_numpy(np.array(v)) for k, v in p.items()},
                       torch.from_numpy(x2d.reshape(B, S, -1)), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_block_f32_and_bf16(experts, arch, cf):
    jcfg, tcfg = cfgs(arch, capacity_factor=cf)
    jp, tp, x = experts[arch]
    fn = jax.jit(lambda p, x: jm.moe_block(p, x, jcfg))
    jp32, tp32 = _f32(jp, tp)
    want = np.asarray(fn(jp32, x))
    got = tm.moe_block(tp32, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(fn(jp, xb), np.float32)
    got = tm.moe_block(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 0.0625 and err.mean() <= 0.004, (err.max(), err.mean())


def test_expert_sum_rounds_once_in_bf16():
    """The experts' contributions are summed in f32 and rounded to bf16
    once, as XLA sums the reference's bf16 (E, T, d) stack: three experts
    whose bf16 outputs round differently when added one by one."""
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b", n_experts=3, top_k=3, capacity_factor=8.0)
    d, f = jcfg.d_model, jcfg.moe_d_ff
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 8, d)).astype(np.float32)
    p = {"router": np.zeros((d, 3), np.float32)}
    for k, s in (("w1", (3, d, f)), ("w3", (3, d, f)), ("w2", (3, f, d))):
        p[k] = (rng.standard_normal(s) * 0.2).astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else torch.bfloat16) for k, v in p.items()}
    want = np.asarray(jax.jit(lambda p, x: jm.moe_block(p, x, jcfg))(jp, jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = tm.moe_block(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg).float().numpy()
    gates, _ = tm._route(torch.from_numpy(x[0]).to(torch.bfloat16), tp["router"], 3)
    assert bool((gates == gates[0, 0]).all())  # equal gates: every token goes to every expert
    xb = torch.from_numpy(x[0]).to(torch.bfloat16)
    terms = [torch.nn.functional.silu(xb @ tp["w1"][e]) * (xb @ tp["w3"][e]) @ tp["w2"][e]
             * gates[0, 0].to(torch.bfloat16) for e in range(3)]
    assert torch.equal(torch.from_numpy(got[0]), (terms[0].float() + terms[1].float() + terms[2].float())
                       .to(torch.bfloat16).float())
    assert (got[0] != (terms[0] + terms[1] + terms[2]).float().numpy()).any()  # bf16 adds round twice
    np.testing.assert_allclose(got, want, rtol=0, atol=2**-6 * np.abs(want).max())


def test_router_aux_loss(experts):
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b")
    jp, tp, x = experts["qwen3-moe-30b-a3b"]
    x2d = x.reshape(B * S, -1)
    want = float(jax.jit(jm.router_aux_loss, static_argnums=(2, 3))(x2d, jp["router"], jcfg.top_k, jcfg.n_experts))
    got = tm.router_aux_loss(torch.from_numpy(x2d), tp["router"], tcfg.top_k, tcfg.n_experts)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # uniform routing scores 1 (importance and load 1/E each, E of them, top-k of them per token)
    flat = tm.router_aux_loss(torch.from_numpy(x2d), torch.zeros_like(tp["router"]), 1, tcfg.n_experts)
    np.testing.assert_allclose(float(flat), float(tcfg.n_experts) * 1 / tcfg.n_experts, rtol=1e-6)


@pytest.mark.parametrize("arch,cf", [("qwen3-moe-30b-a3b", 0.5), ("llama4-scout-17b-a16e", 1.25)])
def test_gradients_of_every_leaf(experts, arch, cf):
    """``jax.grad`` of a weighted sum of the block's output with respect to
    every leaf and the input, at f32, through the routing, the capacity
    picks, the gather and the scatter."""
    jcfg, tcfg = cfgs(arch, capacity_factor=cf)
    jp, tp, x = experts[arch]
    jp32, tp32 = _f32(jp, tp)
    wgt = np.random.default_rng(2).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jm.moe_block(p, x, jcfg) * wgt), argnums=(0, 1)))(jp32, x)
    tleaves = [w.detach().requires_grad_(True) for w in tree.leaves(tp32)]
    tx = torch.from_numpy(x).requires_grad_(True)
    (tm.moe_block(tree.unflatten(tp32, tleaves), tx, tcfg) * torch.from_numpy(wgt)).sum().backward()
    pairs = list(zip(jax.tree.leaves(jg[0]), [w.grad for w in tleaves])) + [(jg[1], tx.grad)]
    for want, got in pairs:
        want = np.asarray(want)
        assert got is not None and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    # top-1 gates are softmax of one value, 1.0: no gradient reaches llama4's router
    assert (np.abs(np.asarray(jg[0]["router"])).max() > 0) == (jcfg.top_k > 1)
