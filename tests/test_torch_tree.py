"""The port's hierarchical count trees against its own streamed round and
against the JAX package's trees.

Against the port's ``stream_fl_round`` (the reference's zero-staleness
claim): the sum tree equals it bit for bit in every plane and b, with E
not dividing M, partial participation, error feedback, a Byzantine
boundary inside an edge and the k-bit wire. Against the jitted reference:
the root merges (the staleness-weighted sum, the median of an even and an
odd number of edges, the trimmed mean) and the three edge attacks exact;
FLSimulation of a median tree of 2 edges under edge_sign_flip and a
trimmed tree of 3 edges on the 4-bit DP wire under edge_inflate, with the bars of
``tests/test_torch_kbit.py::_hold``; the reference's FLConfig checks of
the new fields, one parametrized test; and one small campaign with a
buffered tree under edge_replay and a k-bit cell against the reference's
``run_campaign``.
"""

import functools
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402,F401
from repro import sim as jsim  # noqa: E402
from repro.core import attacks as jatt  # noqa: E402
from repro.fl import FLConfig as JConfig  # noqa: E402
from repro.fl import hierarchy as jh  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro_torch import prng, sim as tsim  # noqa: E402
from repro_torch.core.attacks import EDGE_ATTACK_IDS, apply_edge_attack, edge_attack_id  # noqa: E402
from repro_torch.fl import FLConfig, TreeRoundState, edge_slices  # noqa: E402
from repro_torch.fl import hierarchy as th  # noqa: E402
from repro_torch.fl import rounds as tr  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from test_torch_kbit import BASE, _both, _hold, _t, _task  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

PLANES = ("w_global", "w_locals", "residuals")


def _run(rounds=2, **kw):
    """The port's rounds of one config (BASE + kw) on the CPU from
    PRNGKey(seed): the final state and every round's metrics."""
    p0, cx, cy, test = _task()
    ctx = tr.make_context(FLConfig(**dict(BASE, **kw)), p0, functools.partial(tv.xent_loss, tv.mlp_logits),
                          functools.partial(tv.accuracy, tv.mlp_logits), cx, cy, test, device="cpu")
    params, state, fn = tr.cell_params(ctx.cfg), tr.init_run_state(ctx), tr.round_fn(ctx)
    key, mets = prng.key(ctx.cfg.seed), []
    for _ in range(rounds):
        key, kb, kr = prng.split(key, 3)
        state, met = fn(ctx, params, kr, state, tr.round_batches(ctx, kb))
        mets.append(met)
    return state, mets


@pytest.mark.parametrize("n,e", [(8, 3), (10, 4), (7, 7), (5, 1)])
def test_edge_slices(n, e):
    assert edge_slices(n, e) == jh.edge_slices(n, e)
    assert sum(n_e for _, n_e in edge_slices(n, e)) == n


@pytest.mark.parametrize("extra", [
    dict(),
    dict(participation=0.75),
    dict(error_feedback=True),
    dict(byz_frac=0.25, attack="sign_flip"),
    dict(wire_bits=4, error_feedback=True),
], ids=["plain", "participation", "error_feedback", "sign_flip", "k4-ef"])
def test_sum_tree_equals_stream_round(extra):
    """Three edges over 8 clients in chunks of 2 (slices of 3, 3 and 2):
    every plane and b equal the streamed round's bit for bit, and the loss
    within an ulp (its sum runs edge by edge)."""
    stream, sm = _run(client_chunk=2, **extra)
    tree, tm = _run(client_chunk=2, tree_edges=3, **extra)
    for f in PLANES:
        assert torch.equal(getattr(stream, f), getattr(tree, f)), f
    assert stream.b.b.item() == tree.b.b.item()
    for a, b in zip(sm, tm):
        np.testing.assert_allclose(b["loss"].item(), a["loss"].item(), rtol=2.4e-7)
        assert torch.equal(a["theta"], b["theta"])
    assert tm[0]["edge_mass_min"].item() == 2.0


def test_buffered_tree_degenerates_to_the_sum_tree():
    """edge_buffer = tree_edges at zero latency and decay refreshes every
    slot every round with weight 1: the unbuffered tree, bit for bit."""
    plain, _ = _run(client_chunk=2, tree_edges=3)
    buf, mets = _run(client_chunk=2, tree_edges=3, edge_buffer=3)
    assert isinstance(buf, TreeRoundState) and not isinstance(plain, TreeRoundState)
    for f in PLANES:
        assert torch.equal(getattr(plain, f), getattr(buf, f)), f
    assert [m["buf_fill"].item() for m in mets] == [1.0, 1.0] and mets[-1]["mean_age"].item() == 0.0


def test_root_merges_and_edge_attacks_against_reference():
    """Exact against the jitted reference on integer counts of 4 edges and
    of 3: the staleness-weighted sum, the median (even: the mean of the
    two middle rates), the trimmed mean, and each edge attack with the
    first edge Byzantine (replay from a half-valid previous buffer)."""
    rng = np.random.default_rng(0)
    for n_e in (4, 3):
        mass = np.array([9, 8, 7, 8][:n_e], np.float32)
        counts = np.floor(rng.random((n_e, 4000)) * (mass[:, None] + 1)).astype(np.float32)
        weights = (1.0 + np.arange(n_e, dtype=np.float32)) ** -0.5
        for merge, trim, w in (("sum", 0, weights), ("median", 0, None), ("trimmed", 1, None)):
            cfg = types.SimpleNamespace(edge_merge=merge, edge_trim=trim)
            want = jax.jit(lambda c, m, w: jh._root_merge(cfg, c, m, w))(counts, mass, w)
            got = th._root_merge(cfg, _t(counts), _t(mass), None if w is None else _t(w))
            for g, v in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=f"{merge} E={n_e}")
        prev = (counts[::-1].copy(), mass[::-1].copy(), np.arange(n_e) % 2 == 0)
        byz = np.arange(n_e) < 1
        for name in EDGE_ATTACK_IDS:
            idx = edge_attack_id(name)
            assert idx == jatt.edge_attack_id(name)
            want = jax.jit(lambda c, m, pc, pm, pv, bz: jatt.apply_edge_attack(idx, c, m, pc, pm, pv, bz))(
                counts, mass, *prev, byz)
            got = apply_edge_attack(idx, _t(counts), _t(mass), *(_t(p) for p in prev), _t(byz))
            for g, v in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(tree_edges=2, client_chunk=3, edge_merge="median", byz_edges=1, edge_attack="edge_sign_flip",
         use_kernels=True),
    dict(tree_edges=3, client_chunk=3, edge_merge="trimmed", edge_trim=1, byz_edges=1, edge_attack="edge_inflate",
         wire_bits=4, dp_epsilon=0.5, use_kernels=True, participation=0.75),
], ids=["median-sign_flip-kernel_wire", "trimmed-inflate-k4-dp-kernel_wire-participation"])
def test_tree_against_reference(kw):
    """Two rounds of both packages' FLSimulation (the reference's jitted
    ``tree_fl_round``) on the kernel wire (its plain version here; the
    4-bit wire under DP, randomized response, in the trimmed tree), held to
    _hold's bars. The buffered tree under edge_replay runs in the campaign
    test below."""
    _hold(*_both(**kw))


# What the reference's FLConfig rejects of the ported fields, with the
# message the port must give too.
OK = dict(n_clients=4, rounds=1)
TREE = dict(tree_edges=2, client_chunk=2)
REJECT = [
    (dict(wire_bits=3), "wire_bits must be one of"),
    (dict(wire_bits=2, aggregator="fedavg"), "only supported by the probit_plus wire"),
    (dict(wire_bits=2, topk_frac=0.5), "not supported on the top-k wire"),
    (dict(client_bits=(1, 3, 1, 1)), "client_bits entries must be in"),
    (dict(client_bits=(1, 2)), "one entry per cohort row"),
    (dict(client_bits=(1, 2, 2, 4), aggregator="rsa"), "only supported by probit_plus"),
    (dict(client_bits=(1, 2, 2, 4), use_kernels=True), "kernel wire"),
    (dict(client_bits=(1, 2, 2, 4), client_chunk=2), "cannot stream"),
    (dict(client_bits=(1, 2, 2, 4), async_buffer=2), "async buffer"),
    (dict(client_bits=(1, 2, 2, 4), byz_frac=0.5, attack="bit_flip"), "heterogeneous wire"),
    (dict(tree_edges=-1), "tree_edges must be >= 0"),
    (dict(edge_buffer=1), "requires a hierarchical tree"),
    (dict(edge_merge="median"), "requires a hierarchical tree"),
    (dict(tree_edges=2), "requires client_chunk > 0"),
    (dict(TREE, aggregator="fedavg"), "count-streaming aggregator"),
    (dict(tree_edges=5, client_chunk=2), "exceeds the cohort"),
    (dict(TREE, edge_buffer=3), "exceeds tree_edges"),
    (dict(TREE, edge_attack="nope"), "unknown edge_attack"),
    (dict(TREE, byz_edges=3, edge_attack="edge_inflate"), "byz_edges must be in"),
    (dict(TREE, byz_edges=1), "needs an edge_attack"),
    (dict(TREE, byz_edges=1, edge_attack="edge_replay"), "needs a buffered tree"),
    (dict(TREE, edge_merge="mode"), "unknown edge_merge"),
    (dict(TREE, edge_merge="median", edge_buffer=1), "robust edge merges"),
    (dict(TREE, edge_trim=1), "only applies to edge_merge='trimmed'"),
    (dict(TREE, edge_merge="trimmed", edge_trim=1), "trims away all"),
    (dict(TREE, tree_shard=True), "requires stateless_clients"),
]
ACCEPT = [
    dict(wire_bits=4, dp_epsilon=0.1, client_chunk=2),
    dict(client_bits=[1, 2, 2, 4], dp_epsilon=0.1),
    dict(TREE, edge_buffer=2, async_latency=1.0, staleness_decay=0.5, byz_edges=1, edge_attack="edge_replay"),
    dict(tree_edges=3, client_chunk=3, edge_merge="trimmed", edge_trim=1, wire_bits=4),
]


@pytest.mark.parametrize("kw,match", REJECT + [(kw, None) for kw in ACCEPT],
                         ids=[f"reject-{i}" for i in range(len(REJECT))] + [f"accept-{i}" for i in range(len(ACCEPT))])
def test_config_checks_match_reference(kw, match):
    """A config the reference rejects, the port rejects with a ValueError
    of the same message; one it accepts, the port accepts (client_bits
    normalized to a tuple of ints, as there)."""
    if match is None:
        j, t = JConfig(**OK, **kw), FLConfig(**OK, **kw)
        assert t.client_bits == j.client_bits
        return
    with pytest.raises(ValueError, match=match):
        JConfig(**OK, **kw)
    with pytest.raises(ValueError, match=match):
        FLConfig(**OK, **kw)


def test_tree_shard_raises_naming_a14():
    """tree_shard is ported: a sharded tree the reference accepts, the port
    accepts; the reference's tree_shard checks raise its ValueErrors; and
    without a process group the round warns the reference's one-device
    no-op (as the reference's context does) and equals the unsharded tree
    bit for bit (tests/test_torch_shard.py runs it over ranks)."""
    kw = dict(OK, tree_edges=2, client_chunk=2, stateless_clients=True, tree_shard=True)
    assert FLConfig(**kw) == FLConfig(**kw) and JConfig(**kw).tree_shard
    for bad in (dict(kw, stateless_clients=False), dict(kw, n_clients=8, participation=0.5),
                dict(kw, n_clients=5)):
        with pytest.raises(ValueError) as want:
            JConfig(**bad)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            FLConfig(**bad)
    p0, cx, cy, test = _task()
    one_device = "tree_shard is a no-op: only one local device is visible"
    with pytest.warns(RuntimeWarning, match=one_device):
        jh_ctx = repro.fl.rounds.make_context(JConfig(**dict(BASE, tree_edges=2, client_chunk=2,
                                                             stateless_clients=True, tree_shard=True)),
                                              p0, functools.partial(jv.xent_loss, jv.mlp_logits),
                                              functools.partial(jv.accuracy, jv.mlp_logits), cx, cy, test)
    assert jh.tree_shard_devices(jh_ctx) == 1
    tree_kw = dict(tree_edges=2, client_chunk=2, stateless_clients=True)
    with pytest.warns(RuntimeWarning, match=one_device):
        sharded, sm = _run(tree_shard=True, **tree_kw)
    plain, pm = _run(**tree_kw)
    assert torch.equal(sharded.w_global, plain.w_global)
    for a, c in zip(sm, pm):
        assert set(a) == set(c) and all(torch.equal(a[k], c[k]) for k in a)


def test_campaign_tree_and_kbit_cells_against_reference():
    """One campaign of a buffered tree under edge_replay (3 edges, 2 slots,
    chunks of 2) and a 4-bit cell, seed 0, through both ``run_campaign``s: the same groups with the same memory
    reckoning (the tree term included); per cell, seed and round b exact
    and the loss within rtol 1e-4 (the bar of tests/test_torch_campaign.py:
    XLA contracts the prox step under vmap); each port cell equal to its
    own sequential run."""
    p0, cx, cy, test = _task()
    cells = (("tree_buf", dict(tree_edges=3, client_chunk=2, edge_buffer=2, async_latency=1.0,
                               staleness_decay=0.5, byz_edges=1, edge_attack="edge_replay")),
             ("k4", dict(wire_bits=4)))
    base = dict(BASE, b_mode="fixed")

    def spec(mod):
        return mod.CampaignSpec(base=base, cells=tuple(mod.CellSpec(n, o) for n, o in cells), seeds=(0,))

    jt = jsim.Task(p0, functools.partial(jv.xent_loss, jv.mlp_logits), functools.partial(jv.accuracy, jv.mlp_logits),
                   cx, cy, test)
    tt = tsim.Task(p0, functools.partial(tv.xent_loss, tv.mlp_logits), functools.partial(tv.accuracy, tv.mlp_logits),
                   cx, cy, test, device="cpu")
    jres = jsim.run_campaign(spec(jsim), lambda cfg: jt, compile_cache=jsim.CompileCache())
    tres = tsim.run_campaign(spec(tsim), lambda cfg: tt, compile_cache=tsim.CompileCache())
    assert [g["cells"] for g in tres.groups] == [g["cells"] for g in jres.groups]
    assert [g["peak_bytes_est"] for g in tres.groups] == [g["peak_bytes_est"] for g in jres.groups]
    assert [g["tree_edges"] for g in tres.groups] == [3, 0]
    for jc, tc in zip(jres.cells, tres.cells):
        np.testing.assert_array_equal(tc.metrics["b"], np.asarray(jc.metrics["b"]), err_msg=tc.name)
        np.testing.assert_allclose(tc.metrics["loss"], np.asarray(jc.metrics["loss"]), rtol=1e-4, err_msg=tc.name)
    for (name, over), tc in zip(cells, tres.cells):
        _, mets = _run(**dict(over, b_mode="fixed"))
        np.testing.assert_array_equal(tc.metrics["loss"][0], [m["loss"].item() for m in mets], err_msg=name)
