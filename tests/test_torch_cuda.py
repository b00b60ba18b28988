"""The hand-written CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); skips elsewhere. Imports no JAX, so
on a machine with the card run::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("m", [1, 5, 300])
@pytest.mark.parametrize("d", [997, 40522])
def test_kernels_equal_plain_versions(dev, d, m):
    from repro_torch.kernels.bit_aggregate import bit_aggregate
    from repro_torch.kernels.prox_sgd import prox_sgd
    from repro_torch.kernels.stoch_quant import stoch_quant_ef, stoch_quant_pack

    gen = torch.Generator(device=dev).manual_seed(d + m)
    d_pad = ops.padded_len(d)
    pad = d_pad - d
    b = torch.full((d,), 0.01, device=dev)
    b[:3] = torch.tensor([0.0, -0.01, 0.02], device=dev)
    b_p = F.pad(b, (0, pad), value=1.0)
    delta = F.pad(0.02 * torch.randn(m, d, generator=gen, device=dev), (0, pad), value=-1.0)
    u = F.pad(torch.rand(m, d, generator=gen, device=dev), (0, pad), value=1.0)
    res = F.pad(0.005 * torch.randn(m, d, generator=gen, device=dev), (0, pad))
    packed = stoch_quant_pack(delta, b_p, u)
    assert torch.equal(packed, ref.stoch_quant_compress_ref(delta, b_p, u)[0])
    got = stoch_quant_ef(delta, res, b_p, u)
    want = ref.stoch_quant_compress_ref(delta, b_p, u, res, want_residual=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b_agg = F.pad(b.abs(), (0, pad))
    assert torch.equal(bit_aggregate(packed, b_agg), ref.bit_aggregate_ref(packed, b_agg))
    w, g = torch.randn(m, d, generator=gen, device=dev), torch.randn(m, d, generator=gen, device=dev)
    mom = torch.randn(m, d, generator=gen, device=dev)
    for w0 in (w[0].contiguous(), 0.9 * w):
        coeffs = ops.prox_coeffs(0.01, 0.2, 0.5, dev)
        got = prox_sgd(w, w0, g, mom, coeffs)
        want = ref.prox_sgd_ref(w, w0, g, mom, coeffs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _prox_cases(w, g, mom):
    """(w0, tag) of both w0 forms: one shared row and a full operand."""
    return ((0.9 * w[0] + 0.1, "shared"), (0.9 * w + 0.1, "full"))


@pytest.mark.parametrize("m", [1, 7, 100])
@pytest.mark.parametrize("d", [4096, 997, 40522, 4099])
def test_prox_sgd_equals_plain_version_at_every_alignment(dev, d, m):
    """B4 bit for bit at d = 0, 1, 2 and 3 (mod 4), so rows starting at
    every 16-byte phase (the scalar head and tail of the peel); d below one
    column tile (997) and not a multiple of it (4099, 40522); M = 1 and
    M = 7, which the row groups below do not divide. Through the wrapper
    out of place and in place (out= aliasing w and the momentum), through
    the C entry at other geometries (one CTA for every unit, fewer CTAs than
    units, more CTAs than units, the smallest tile), on the scalar path
    alone, on operands all 4 bytes past a 16-byte boundary, and with w alone
    off its boundary (the wrapper then takes the scalar path)."""
    from repro_torch.kernels.prox_sgd import launch_geometry, occupancy, prox_sgd

    coeffs = ops.prox_coeffs(0.01, 0.2, 0.5, dev)
    gen = torch.Generator(device=dev).manual_seed(d * 1000 + m)
    w, g, mom = (torch.randn(m, d, generator=gen, device=dev) for _ in range(3))
    lib = _build.library("prox_sgd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for w0, form in _prox_cases(w, g, mom):
        want = ref.prox_sgd_ref(w, w0, g, mom, coeffs)

        def same(got):
            return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

        assert same(prox_sgd(w, w0, g, mom, coeffs)), form
        w_io, m_io = w.clone(), mom.clone()
        assert same(prox_sgd(w_io, w0, g, m_io, coeffs, out=(w_io, m_io))), form
        shared = form == "shared"
        chosen = launch_geometry(m, d, *occupancy(dev.index, shared))
        for geometry in (chosen, (2048, 1, 1), (2048, 3, 5), (1024, 100, 2), (8192, 2, 1000), (4, 5, 7)):
            for vector in (1, 0):
                outs = (torch.full_like(w, float("nan")), torch.full_like(w, float("nan")))
                rc = lib.probit_prox_sgd(w.data_ptr(), w0.data_ptr(), g.data_ptr(), mom.data_ptr(),
                                         outs[0].data_ptr(), outs[1].data_ptr(), coeffs.data_ptr(), 0, m, d,
                                         m if shared else 1, *geometry, vector, stream)
                assert rc == 0 and same(outs), (form, geometry, vector)
        flats = [torch.empty(m * d + 1, device=dev) for _ in range(6)]
        views = [f[1:].view(m, d) for f in flats]
        for v, src in zip(views, (w, g, mom, w, mom, w0.expand(m, d))):
            v.copy_(src)
        w0_off = w0 if shared else views[5]
        assert same(prox_sgd(views[0], w0_off, views[1], views[2], coeffs)), form
        assert same(prox_sgd(views[3], w0_off, views[1], views[4], coeffs, out=(views[3], views[4]))), form
        assert same(prox_sgd(views[0], w0, g, mom, coeffs)), form


@pytest.mark.parametrize("m", [1, 8])
def test_prox_sgd_at_resnet_width(dev, m):
    """B4 at ResNet-18's d = 11,172,042 (rows of two, w0 beyond L2), both w0
    forms, out of place and in place."""
    from repro_torch.kernels.prox_sgd import prox_sgd

    d, coeffs = 11_172_042, ops.prox_coeffs(0.01, 0.2, 0.5, dev)
    gen = torch.Generator(device=dev).manual_seed(m)
    w, g, mom = (torch.randn(m, d, generator=gen, device=dev) for _ in range(3))
    for w0, form in _prox_cases(w, g, mom):
        want = ref.prox_sgd_ref(w, w0, g, mom, coeffs)
        got = prox_sgd(w, w0, g, mom, coeffs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), form
        w_io, m_io = w.clone(), mom.clone()
        prox_sgd(w_io, w0, g, m_io, coeffs, out=(w_io, m_io))
        assert torch.equal(w_io, want[0]) and torch.equal(m_io, want[1]), form


def test_ops_engines_agree_on_card(dev):
    d, m = 40522, 9
    gen = torch.Generator(device=dev).manual_seed(3)
    deltas = 0.02 * torch.randn(m, d, generator=gen, device=dev)
    res = 0.005 * torch.randn(m, d, generator=gen, device=dev)
    b = torch.full((d,), 0.01, device=dev)
    key = prng.key(4, dev)
    for resid in (None, res):
        k = ops.stoch_quant_compress_batch(key, deltas, b, residual=resid, want_residual=resid is not None)
        r = ops.stoch_quant_compress_batch(key, deltas, b, residual=resid, want_residual=resid is not None,
                                           engine="ref")
        assert torch.equal(k[0], r[0])
        assert (k[1] is None and r[1] is None) or torch.equal(k[1], r[1])
        theta = ops.bit_aggregate(k[0], b, d)
        assert torch.equal(theta, ops.bit_aggregate(k[0], b, d, engine="ref"))


@pytest.mark.parametrize("d", [997, 118_282])
def test_single_client_entries_equal_plain_versions(dev, d):
    """One client's ``stoch_quant_compress`` / ``stoch_quant_pack`` through
    B1 and B2 equal the plain engine bit for bit, without a residual, with
    one and with ``want_residual``; each call launches its one kernel."""
    gen = torch.Generator(device=dev).manual_seed(d)
    delta = 0.02 * torch.randn(d, generator=gen, device=dev)
    res = 0.005 * torch.randn(d, generator=gen, device=dev)
    b = torch.full((d,), 0.01, device=dev)
    b[:2] = 0.0
    key = prng.fold_in(prng.key(5, dev), 7)
    for resid, want_res, kernel in ((None, False, "stoch_quant_pack"), (res, False, "stoch_quant_ef"),
                                    (None, True, "stoch_quant_ef"), (res, True, "stoch_quant_ef")):
        _build.reset_launches()
        kp, kr = ops.stoch_quant_compress(key, delta, b, resid, want_residual=want_res)
        assert dict(_build.launches) == {kernel: 1}
        rp, rr = ops.stoch_quant_compress(key, delta, b, resid, want_residual=want_res, engine="ref")
        assert torch.equal(kp, rp) and kp.shape == (ops.padded_len(d) // 8,)
        assert (kr is None and rr is None) if not want_res else torch.equal(kr, rr)
    assert torch.equal(ops.stoch_quant_pack(key, delta, b), ops.stoch_quant_pack(key, delta, b, engine="ref"))


def test_bit_aggregate_padded_tail_on_card(dev):
    n, m = 997, 5
    pbytes = ops.padded_len(n) // 8
    gen = torch.Generator(device=dev).manual_seed(11)
    packed = torch.randint(0, 256, (m, pbytes), generator=gen, device=dev, dtype=torch.uint8)
    b = torch.rand(n, generator=gen, device=dev)
    base = ops.bit_aggregate(packed, b, n)
    poisoned = packed.clone()
    full = n // 8
    poisoned[:, full] |= (0xFF << (8 - (8 * (full + 1) - n))) & 0xFF
    poisoned[:, full + 1:] = 0xFF
    assert torch.equal(ops.bit_aggregate(poisoned, b, n), base)


@pytest.mark.parametrize("fill", ["random", "ones", "zeros"])
@pytest.mark.parametrize(
    "n,m",
    [(997, m) for m in (1, 7, 8, 100, 255, 256, 257, 500, 1_000, 70_001, 150_001)] + [(118_282, 10_000)],
)
def test_bit_aggregate_equals_plain_version(dev, n, m, fill):
    """B3 bit for bit at every cluster size (1 block a tile up to M = 384,
    2 at 500, 4 at 1,000, 8 beyond), past 2**16 votes a
    coordinate (70,001), past a flush of its byte-lane counters (150,001:
    more than 4,080 rows a row stream) and at the main path's width; all-ones
    and all-zeros wires put every count at M and at 0. Nothing is written at
    or beyond n."""
    from repro_torch.kernels.bit_aggregate import bit_aggregate

    p = ops.padded_len(n) // 8
    gen = torch.Generator(device=dev).manual_seed(n + m)
    if fill == "random":
        packed = torch.randint(0, 256, (m, p), generator=gen, device=dev, dtype=torch.uint8)
    else:
        packed = torch.full((m, p), 0xFF if fill == "ones" else 0, device=dev, dtype=torch.uint8)
    b = torch.rand(8 * p, generator=gen, device=dev) + 0.5
    buf = torch.full((8 * p,), float("nan"), device=dev)
    got = bit_aggregate(packed, b[:n], out=buf[:n])
    assert torch.equal(got, ref.bit_aggregate_ref(packed, b[:n]))
    assert torch.equal(got, ref.bit_aggregate_ref(packed, b)[:n])
    assert bool(buf[n:].isnan().all())


@pytest.mark.parametrize("m", [7, 500, 70_001])
@pytest.mark.parametrize("offset", [0, 1])
def test_bit_aggregate_unaligned_rows(dev, m, offset):
    """P = 125 bytes a row (P % 4 != 0), and a wire that starts one byte
    past an allocation: rows are not on 4-byte boundaries, so the kernel
    reads bytes; the last word of a row is cut at n = 997 (125 bytes)."""
    from repro_torch.kernels.bit_aggregate import bit_aggregate

    n, p = 997, 125
    gen = torch.Generator(device=dev).manual_seed(m + offset)
    flat = torch.randint(0, 256, (m * p + offset,), generator=gen, device=dev, dtype=torch.uint8)
    packed = flat[offset:].view(m, p)
    b = torch.rand(n, generator=gen, device=dev)
    assert torch.equal(bit_aggregate(packed, b), ref.bit_aggregate_ref(packed, b))


def test_round_on_kernels_equals_round_on_plain_versions(dev):
    """A small FLSimulation through the kernels equals the same run with
    engine='ref' on the card, round by round, and launches every kernel.
    With use_kernels=False (the plain versions and the chunked packer's
    wire) it launches none and gives the same rounds."""
    from repro_torch.data import make_classification, partition_label_skew
    from repro_torch.fl import FLConfig, FLSimulation
    from repro_torch.models import accuracy, init_mlp, mlp_logits, xent_loss

    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=100)
    parts = partition_label_skew(ytr, 6, 2, 20, seed=1)
    cx, cy = np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts])
    p0 = init_mlp(prng.key(0), hidden=16)
    runs = {}
    for engine in (None, "ref", "off"):
        for ef in (False, True):
            _build.reset_launches()
            sim = FLSimulation(FLConfig(n_clients=6, rounds=2, local_epochs=2, use_kernels=engine != "off",
                                        error_feedback=ef),
                               p0, functools.partial(xent_loss, mlp_logits),
                               functools.partial(accuracy, mlp_logits), cx, cy, {"x": xte, "y": yte},
                               device=dev, engine=None if engine == "off" else engine)
            runs[engine, ef] = ([(m["theta"].clone(), m["loss"].item(), m["b"].item())
                                 for _, m in sim.iter_rounds()], dict(_build.launches))
    for ef in (False, True):
        (kern, kl), (plain, pl), (off, ol) = runs[None, ef], runs["ref", ef], runs["off", ef]
        assert pl == {} and ol == {}
        assert kl["bit_aggregate"] == 2 and kl["prox_sgd"] == 2 * 4
        assert kl["stoch_quant_ef" if ef else "stoch_quant_pack"] == 2
        for (t1, l1, b1), (t2, l2, b2), (t3, l3, b3) in zip(kern, plain, off):
            assert torch.equal(t1, t2) and l1 == l2 and b1 == b2
            assert torch.equal(t1, t3) and l1 == l3 and b1 == b3


def test_normal_and_choice_on_card_equal_cpu(dev):
    """The card's prng.normal equals the CPU's bit for bit at the gaussian
    attack's full-width shape, and choice/permutation equal theirs."""
    k = prng.fold_in(prng.key(21), 1)
    got = prng.normal(k.to(dev), (30, 118_282), scale=10.0).cpu()
    assert torch.equal(got.view(torch.int32), prng.normal(k, (30, 118_282), scale=10.0).view(torch.int32))
    for n in (1, 7, 100, 1000, 2000):
        assert torch.equal(prng.permutation(k.to(dev), n).cpu(), prng.permutation(k, n))
        assert torch.equal(prng.choice(k.to(dev), n, (max(n // 2, 1),)).cpu(), prng.choice(k, n, (max(n // 2, 1),)))


@pytest.mark.parametrize("aggregator", ["probit_plus", "fedavg", "fed_gm", "signsgd_mv", "rsa"])
def test_every_attack_b_mode_and_participation_on_card(dev, aggregator):
    """Each attack under every b_mode at full and half participation, a
    third of each cohort Byzantine: one round through the kernels equals
    the engine='ref' round and launches B1 and B3 once (PRoBit+ only) and
    B4 once a local step."""
    from repro_torch.data import make_classification, partition_label_skew
    from repro_torch.fl import FLConfig, FLSimulation
    from repro_torch.models import accuracy, init_mlp, mlp_logits, xent_loss

    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=100)
    parts = partition_label_skew(ytr, 6, 2, 20, seed=1)
    cx, cy = np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts])
    p0 = init_mlp(prng.key(0), hidden=16)
    attacks = ("none", "gaussian", "sign_flip", "zero_gradient", "sample_duplicate", "alie", "ipm", "bit_flip")
    for attack in attacks:
        for b_mode in ("dynamic", "fixed", "oracle"):
            for participation in (0.5, 1.0):
                cfg = FLConfig(n_clients=6, rounds=1, local_epochs=1, use_kernels=True, aggregator=aggregator,
                               attack=attack, byz_frac=0.34, b_mode=b_mode, participation=participation)
                out = []
                for engine in (None, "ref"):
                    _build.reset_launches()
                    sim = FLSimulation(cfg, p0, functools.partial(xent_loss, mlp_logits),
                                       functools.partial(accuracy, mlp_logits), cx, cy, {"x": xte, "y": yte},
                                       device=dev, engine=engine)
                    (_, met), = sim.iter_rounds()
                    out.append((met["theta"].clone(), met["loss"].item(), met["b"].item(), dict(_build.launches)))
                (t1, l1, b1, kl), (t2, l2, b2, rl) = out
                pp = aggregator == "probit_plus"
                assert kl == {"prox_sgd": 2, **({"stoch_quant_pack": 1, "bit_aggregate": 1} if pp else {})}, cfg
                assert rl == {}
                assert torch.equal(t1, t2) and l1 == l2 and b1 == b2, cfg
                assert np.isfinite(l1) and bool(torch.isfinite(t1).all()), cfg


def test_blocked_uniforms_on_card_equal_cpu(dev, monkeypatch):
    """The row-blocked uniform draw on the card equals the CPU's whole-cohort
    draw bit for bit, with a block that does not divide M, and the kernel
    engine's compress through it equals the plain engine's."""
    from repro_torch.core import quantizer as tq

    key, m, n = prng.fold_in(prng.key(17), 3), 7, 1_000_003
    want = tq.client_uniforms(prng.fold_in(key, 5 + torch.arange(m)), n)
    monkeypatch.setattr(tq, "UNIFORM_BLOCK_WORDS", 3 * tq.padded_dim(n))  # blocks of 3 rows
    got = tq.cohort_uniforms(key.to(dev), m, n, row_offset=5).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    deltas = 0.01 * torch.randn(m, n, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    b = torch.tensor(0.012, device=dev)
    kp, _ = ops.stoch_quant_compress_batch(key.to(dev), deltas, b, row_offset=5, engine="cuda")
    rp, _ = ops.stoch_quant_compress_batch(key.to(dev), deltas, b, row_offset=5, engine="ref")
    assert torch.equal(kp, rp)


@pytest.fixture
def f32_convolutions():
    """Full-f32 convolutions and matmuls (no TF32) with deterministic cuDNN
    algorithms for the test; the previous settings are restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


@pytest.mark.parametrize("model", ["cnn", "resnet"])
def test_grouped_convolution_equals_loop_over_clients_on_card(dev, f32_convolutions, model):
    """One grouped convolution a layer for 5 clients gives each client the
    loss and gradient its own model gives it alone (rtol 1e-5), and the
    card's cohort losses equal the CPU's to the same tolerance."""
    from repro_torch import interop
    from repro_torch.models import vision as tv

    if model == "cnn":
        p, logits, shape = tv.init_cnn(prng.key(1), width=8, img=16), tv.cnn_logits, (16, 16, 1)
    else:
        blocks = (1, 1, 1, 1)
        p = tv.init_resnet(prng.key(1), width=8, blocks=blocks)
        logits, shape = functools.partial(tv.resnet_logits, blocks=blocks), (16, 16, 3)
    flat, unravel = interop.ravel_params(p)
    gen = torch.Generator().manual_seed(2)
    ws = torch.stack([flat * (1 + 0.1 * i) for i in range(5)])
    batch = {"x": torch.randn((5, 6) + shape, generator=gen), "y": torch.randint(0, 10, (5, 6), generator=gen)}
    cpu_losses = tv.xent_loss(logits, unravel(ws), batch)
    ws_d = ws.to(dev).requires_grad_(True)
    batch_d = {k: v.to(dev) for k, v in batch.items()}
    losses = tv.xent_loss(logits, unravel(ws_d), batch_d)
    (grads,) = torch.autograd.grad(losses.sum(), ws_d)
    np.testing.assert_allclose(losses.detach().cpu().numpy(), cpu_losses.numpy(), rtol=1e-5)
    for i in range(5):
        w = ws[i].to(dev).requires_grad_(True)
        one = tv.xent_loss(logits, unravel(w), {k: v[i] for k, v in batch_d.items()})
        (g,) = torch.autograd.grad(one, w)
        np.testing.assert_allclose(losses[i].item(), one.item(), rtol=1e-5)
        np.testing.assert_allclose(grads[i].cpu().numpy(), g.cpu().numpy(), rtol=1e-5, atol=1e-6)


def test_cnn_round_on_kernels_equals_round_on_plain_versions(dev, f32_convolutions):
    """A tiny CNN FLSimulation through the kernels equals the engine='ref'
    run on the card round for round, and launches every kernel."""
    from repro_torch.data import make_image_classification, partition_label_skew
    from repro_torch.fl import FLConfig, FLSimulation
    from repro_torch.models import accuracy, cnn_logits, init_cnn, xent_loss

    (xtr, ytr), (xte, yte) = make_image_classification(0, img=8, n_train=600, n_test=100)
    parts = partition_label_skew(ytr, 6, 2, 20, seed=1)
    cx, cy = np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts])
    p0 = init_cnn(prng.key(0), width=4, img=8)
    for ef in (False, True):
        runs = []
        for engine in (None, "ref"):
            _build.reset_launches()
            sim = FLSimulation(FLConfig(n_clients=6, rounds=2, local_epochs=2, use_kernels=True, error_feedback=ef),
                               p0, functools.partial(xent_loss, cnn_logits), functools.partial(accuracy, cnn_logits),
                               cx, cy, {"x": xte, "y": yte}, device=dev, engine=engine)
            runs.append(([(m["theta"].clone(), m["loss"].item(), m["b"].item()) for _, m in sim.iter_rounds()],
                         dict(_build.launches)))
        (kern, kl), (plain, pl) = runs
        assert pl == {}
        assert kl == {"prox_sgd": 8, "bit_aggregate": 2, ("stoch_quant_ef" if ef else "stoch_quant_pack"): 2}
        for (t1, l1, b1), (t2, l2, b2) in zip(kern, plain):
            assert torch.equal(t1, t2) and l1 == l2 and b1 == b2 and np.isfinite(l1)


def _mlp_task():
    from repro_torch.data import make_classification, partition_label_skew
    from repro_torch.models import init_mlp

    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=100)
    parts = partition_label_skew(ytr, 6, 2, 20, seed=1)
    cx, cy = np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts])
    return init_mlp(prng.key(0), hidden=16), cx, cy, {"x": xte, "y": yte}


@pytest.mark.parametrize("kw,launches", [
    # async: B1 once a round, B4 once a local step, no B3 (the weighted estimate is plain)
    ({"async_buffer": 3, "async_latency": 1.0, "staleness_decay": 0.5, "byz_frac": 0.34,
      "attack": "straggler+sign_flip"}, {"stoch_quant_pack": 2, "prox_sgd": 8}),
    ({"async_buffer": 6}, {"stoch_quant_pack": 2, "prox_sgd": 8}),
    # streamed in chunks of 4 (6 clients: a pad chunk): B1 and 4 B4 a chunk
    ({"client_chunk": 4, "error_feedback": True}, {"stoch_quant_ef": 4, "prox_sgd": 16}),
    ({"client_chunk": 4, "stateless_clients": True, "byz_frac": 0.34, "attack": "gaussian"},
     {"stoch_quant_pack": 4, "prox_sgd": 16}),
], ids=["async-straggler", "async-full", "stream-ef", "stream-stateless-gaussian"])
def test_async_and_stream_rounds_on_kernels_equal_plain_versions(dev, kw, launches):
    """Two asynchronous or streamed rounds of a small FLSimulation through
    the kernels equal the engine='ref' rounds on the card (theta, loss, b,
    and the asynchronous buffer), with their own launch counts."""
    from repro_torch.fl import FLConfig, FLSimulation
    from repro_torch.models import accuracy, mlp_logits, xent_loss

    p0, cx, cy, test = _mlp_task()
    runs = []
    for engine in (None, "ref"):
        _build.reset_launches()
        sim = FLSimulation(FLConfig(n_clients=6, rounds=2, local_epochs=2, use_kernels=True, **kw), p0,
                           functools.partial(xent_loss, mlp_logits), functools.partial(accuracy, mlp_logits),
                           cx, cy, test, device=dev, engine=engine)
        rounds = [(m["theta"].clone(), m["loss"].item(), m["b"].item()) for _, m in sim.iter_rounds()]
        runs.append((rounds, dict(_build.launches), sim.state))
    (kern, kl, ks), (plain, pl, ps) = runs
    assert pl == {} and kl == launches
    for (t1, l1, b1), (t2, l2, b2) in zip(kern, plain):
        assert torch.equal(t1, t2) and l1 == l2 and b1 == b2 and np.isfinite(l1)
    if "async_buffer" in kw:
        for f in ("buf_rows", "buf_age", "buf_valid", "buf_owner"):
            assert torch.equal(getattr(ks, f), getattr(ps, f)), f


@pytest.mark.parametrize("m,k", [(7, 99), (100, 11_828)])
def test_quant_pack_u_equals_plain_version(dev, m, k):
    """B1 through ops.quant_pack_u on top-k row sets (k not a multiple of 8,
    one b row a client, one launch) equals the plain version bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(k)
    d_sel = 0.02 * torch.randn(m, k, generator=gen, device=dev)
    b_sel = 0.005 + 0.02 * torch.rand(m, k, generator=gen, device=dev)
    u = torch.rand(m, k, generator=gen, device=dev)
    _build.reset_launches()
    got = ops.quant_pack_u(d_sel, b_sel, u)
    assert dict(_build.launches) == {"stoch_quant_pack": 1}
    assert torch.equal(got, ops.quant_pack_u(d_sel, b_sel, u, engine="ref"))


@pytest.mark.parametrize("kw,launches", [
    # the k-bit wire (randomized response under DP): no pack or count kernel, B4 a local step
    ({"wire_bits": 4, "dp_epsilon": 0.5}, {"prox_sgd": 8}),
    # top-k: B1 once a round for the cohort's gathered values, error feedback or not
    ({"topk_frac": 0.1, "error_feedback": True, "byz_frac": 0.34, "attack": "bit_flip"},
     {"stoch_quant_pack": 2, "prox_sgd": 8}),
    # trees of 6 clients: B1 (B2 with error feedback) once a chunk, B4 a local step of each chunk
    ({"tree_edges": 2, "client_chunk": 2, "edge_merge": "median", "byz_edges": 1, "edge_attack": "edge_sign_flip"},
     {"stoch_quant_pack": 8, "prox_sgd": 32}),
    ({"tree_edges": 3, "client_chunk": 2, "edge_buffer": 2, "async_latency": 1.0, "staleness_decay": 0.5,
      "byz_edges": 1, "edge_attack": "edge_replay", "error_feedback": True}, {"stoch_quant_ef": 6, "prox_sgd": 24}),
    ({"tree_edges": 3, "client_chunk": 2, "wire_bits": 2, "edge_merge": "trimmed", "edge_trim": 1}, {"prox_sgd": 24}),
], ids=["k4-dp", "topk-ef-bit_flip", "tree-median", "tree-buffered-ef", "tree-trimmed-k2"])
def test_wires_and_trees_on_kernels_equal_plain_versions(dev, kw, launches):
    """Two rounds of the k-bit, top-k and tree paths through the kernels
    equal the engine='ref' rounds on the card (theta, loss, b, and a
    buffered tree's buffer), with their own launch counts."""
    from repro_torch.fl import FLConfig, FLSimulation
    from repro_torch.models import accuracy, mlp_logits, xent_loss

    p0, cx, cy, test = _mlp_task()
    runs = []
    for engine in (None, "ref"):
        _build.reset_launches()
        sim = FLSimulation(FLConfig(n_clients=6, rounds=2, local_epochs=2, use_kernels=True, **kw), p0,
                           functools.partial(xent_loss, mlp_logits), functools.partial(accuracy, mlp_logits),
                           cx, cy, test, device=dev, engine=engine)
        rounds = [(m["theta"].clone(), m["loss"].item(), m["b"].item()) for _, m in sim.iter_rounds()]
        runs.append((rounds, dict(_build.launches), sim.state))
    (kern, kl, ks), (plain, pl, ps) = runs
    assert pl == {} and kl == launches
    for (t1, l1, b1), (t2, l2, b2) in zip(kern, plain):
        assert torch.equal(t1, t2) and l1 == l2 and b1 == b2 and np.isfinite(l1)
    for f in ("edge_counts", "edge_mass", "edge_age", "edge_valid"):
        if hasattr(ks, f):
            assert torch.equal(getattr(ks, f), getattr(ps, f)), f


def test_sum_tree_equals_stream_round_on_card(dev):
    """A sum tree of 3 edges equals the streamed round in chunks of 2 on the
    card, through the kernels, in every plane and b (the reference's
    zero-staleness claim), error feedback on."""
    from repro_torch.fl import FLConfig, FLSimulation
    from repro_torch.models import accuracy, mlp_logits, xent_loss

    p0, cx, cy, test = _mlp_task()
    states = []
    for extra in ({}, {"tree_edges": 3}):
        sim = FLSimulation(FLConfig(n_clients=6, rounds=2, local_epochs=2, use_kernels=True, client_chunk=2,
                                    error_feedback=True, **extra), p0, functools.partial(xent_loss, mlp_logits),
                           functools.partial(accuracy, mlp_logits), cx, cy, test, device=dev)
        for _ in sim.iter_rounds():
            pass
        states.append(sim.state)
    for f in ("w_global", "w_locals", "residuals"):
        assert torch.equal(getattr(states[0], f), getattr(states[1], f)), f
    assert torch.equal(states[0].b.b, states[1].b.b)


@pytest.mark.parametrize("e", [1, 3, 8])
def test_batched_kernels_equal_plain_versions(dev, e):
    """Each kernel over a group of E runs in one launch, each run with its
    own range b, its own counts and estimate, its own w0 row and (eta, lam,
    mu), bit for bit against the plain versions: B1/B2 and B3 at 5 clients a
    run, B4 at 5 rows a run (and at ResNet-18's width, where units take two
    rows, 3 rows a run: a row group does not divide the run) through the
    wrapper and the C entry at other geometries."""
    from repro_torch.kernels.bit_aggregate import bit_aggregate
    from repro_torch.kernels.prox_sgd import prox_sgd
    from repro_torch.kernels.stoch_quant import stoch_quant_ef, stoch_quant_pack

    gen = torch.Generator(device=dev).manual_seed(e)
    m, d = 5, 40522
    d_pad = ops.padded_len(d)
    b = F.pad(0.005 + 0.02 * torch.rand(e, d, generator=gen, device=dev), (0, d_pad - d), value=1.0)
    delta = F.pad(0.02 * torch.randn(e * m, d, generator=gen, device=dev), (0, d_pad - d), value=-1.0)
    u = F.pad(torch.rand(e * m, d, generator=gen, device=dev), (0, d_pad - d), value=1.0)
    res = F.pad(0.005 * torch.randn(e * m, d, generator=gen, device=dev), (0, d_pad - d))
    packed = stoch_quant_pack(delta, b, u)
    assert torch.equal(packed, ref.stoch_quant_compress_ref(delta, b, u)[0])
    got = stoch_quant_ef(delta, res, b, u)
    want = ref.stoch_quant_compress_ref(delta, b, u, res, want_residual=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    wire = packed.view(e, m, -1)
    assert torch.equal(bit_aggregate(wire, b[:, :d].contiguous()), ref.bit_aggregate_ref(wire, b[:, :d]))
    for i in range(e):
        assert torch.equal(bit_aggregate(wire[i].contiguous(), b[i, :d].contiguous()),
                           ref.bit_aggregate_ref(wire, b[:, :d])[i])
    lib = _build.library("prox_sgd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    coeffs = torch.stack([0.01 + 0.01 * torch.arange(e, device=dev), 0.2 * (torch.arange(e, device=dev) % 2),
                          torch.full((e,), 0.5, device=dev)], -1).contiguous()
    for rows, width in ((5, 4099), (3, 11_172_042)):
        w, g, mom = (torch.randn(e * rows, width, generator=gen, device=dev) for _ in range(3))
        w0 = torch.randn(e, width, generator=gen, device=dev)
        want = ref.prox_sgd_ref(w, w0, g, mom, coeffs)
        got = prox_sgd(w, w0, g, mom, coeffs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (rows, width)
        w_io, m_io = w.clone(), mom.clone()
        prox_sgd(w_io, w0, g, m_io, coeffs, out=(w_io, m_io))
        assert torch.equal(w_io, want[0]) and torch.equal(m_io, want[1]), (rows, width)
        for geometry in ((2048, 1, 1), (2048, 2, 7), (1024, 4, 64)):
            w_out, m_out = torch.full_like(w, float("nan")), torch.full_like(w, float("nan"))
            rc = lib.probit_prox_sgd(w.data_ptr(), w0.data_ptr(), g.data_ptr(), mom.data_ptr(), w_out.data_ptr(),
                                     m_out.data_ptr(), coeffs.data_ptr(), 3, e * rows, width, rows, *geometry, 1,
                                     stream)
            assert rc == 0 and torch.equal(w_out, want[0]) and torch.equal(m_out, want[1]), (rows, width, geometry)
        del w, g, mom, w0, want, got, w_io, m_io, w_out, m_out


def test_campaign_on_kernels_equals_plain_versions(dev):
    """A small campaign on the card through the kernels equals its
    engine='ref' rerun exactly (every metric of every round and each run's
    final global model), and each batched synchronous group launches B1
    (B2 with error feedback) and B3 once a round and B4 once a local step
    for all its runs; the fused M-sweep counts with the weighted plain
    count (no B3), and so do the asynchronous group (B1 once a round, B4
    once a local step, for all its runs) and the streamed group (chunks of
    4 of 6: B1 once a chunk, B4 once a local step of each chunk); the
    2-bit wire's group, the top-k wire's and the sum tree's (2 edges of 3)
    run as one group too: no B1 on the 2-bit wire, B1 once a round on the
    top-k wire's gathered values, B1 once an edge's chunk on the tree, and
    B4 once a local step (of each edge's chunk), for all the group's
    runs."""
    from repro_torch.data import make_classification, partition_label_skew
    from repro_torch.models import accuracy, init_mlp, mlp_logits, xent_loss
    from repro_torch.sim import CampaignSpec, CellSpec, Task, plan_campaign
    from repro_torch.sim import campaign as campaign_mod
    from repro_torch.sim.plan import CompileCache

    (xtr, ytr), (xte, yte) = make_classification(0, n_train=600, n_test=100)
    p0 = init_mlp(prng.key(0), hidden=16)

    @functools.lru_cache(maxsize=None)
    def data(m):
        parts = partition_label_skew(ytr, m, 2, 20, seed=1)
        return np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts])

    spec = CampaignSpec(
        base=dict(rounds=2, local_epochs=2, use_kernels=True),
        cells=(CellSpec("gauss", {"n_clients": 6, "byz_frac": 0.34, "attack": "gaussian"}),
               CellSpec("flip", {"n_clients": 6, "byz_frac": 0.34, "attack": "bit_flip", "lr": 0.02}),
               CellSpec("ef", {"n_clients": 6, "error_feedback": True}),
               CellSpec("M4", {"n_clients": 4}), CellSpec("M5", {"n_clients": 5}),
               CellSpec("async", {"n_clients": 6, "async_buffer": 6, "async_latency": 1.0}),
               CellSpec("async_decay", {"n_clients": 6, "async_buffer": 6, "async_latency": 1.0,
                                        "staleness_decay": 0.5}),
               CellSpec("stream", {"n_clients": 6, "client_chunk": 4, "byz_frac": 0.34, "attack": "bit_flip"}),
               CellSpec("stream2", {"n_clients": 6, "client_chunk": 4, "byz_frac": 0.34, "attack": "gaussian"}),
               CellSpec("kbit", {"n_clients": 6, "wire_bits": 2}),
               CellSpec("topk", {"n_clients": 6, "topk_frac": 0.3}),
               CellSpec("tree", {"n_clients": 6, "tree_edges": 2, "client_chunk": 3})),
        seeds=(0, 1))
    plan = plan_campaign(spec)
    cfgs = spec.configs()
    steps = 2 * 20 // 10
    runs = {}
    for engine in (None, "ref"):
        def task_fn(cfg):
            cx, cy = data(cfg.n_clients)
            return Task(p0, functools.partial(xent_loss, mlp_logits), functools.partial(accuracy, mlp_logits),
                        cx, cy, {"x": xte, "y": yte}, device=dev, engine=engine)

        for group in plan.groups:
            prepare, args, *_ = campaign_mod._prepare_group(group, cfgs, spec, task_fn, with_acc=True, shard=False,
                                                            cache=CompileCache())
            runner = prepare(*args)
            _build.reset_launches()
            traj, final = runner.run()
            torch.cuda.synchronize()
            runs[engine, group.cell_idx] = (traj, final, dict(_build.launches))
    for group in plan.groups:
        (kt, kf, kl), (rt, rf, rl) = runs[None, group.cell_idx], runs["ref", group.cell_idx]
        assert rl == {}
        assert torch.equal(kf, rf) and set(kt) == set(rt)
        for name in kt:
            assert torch.equal(kt[name], rt[name]), (group.cell_idx, name)
        names = {spec.cells[i].name for i in group.cell_idx}
        e = len(group.cell_idx) * 2
        if names == {"gauss", "flip"}:
            assert kl == {"stoch_quant_pack": 2, "bit_aggregate": 2, "prox_sgd": 2 * steps}
        elif names == {"ef"}:
            assert kl == {"stoch_quant_ef": 2, "bit_aggregate": 2, "prox_sgd": 2 * steps}
        elif names == {"M4", "M5"}:
            assert group.fused and kl == {"stoch_quant_pack": 2, "prox_sgd": 2 * steps}
        elif names == {"stream", "stream2"}:
            assert kl == {"stoch_quant_pack": 2 * 2, "prox_sgd": 2 * steps * 2}
        elif names == {"kbit"}:
            assert kl == {"prox_sgd": 2 * steps}
        elif names == {"topk"}:
            assert kl == {"stoch_quant_pack": 2, "prox_sgd": 2 * steps}
        elif names == {"tree"}:
            assert kl == {"stoch_quant_pack": 2 * 2, "prox_sgd": 2 * steps * 2}
        else:
            assert names == {"async", "async_decay"} and e == 4
            assert kl == {"stoch_quant_pack": 2, "prox_sgd": 2 * steps}


def test_campaign_cache_keeps_no_client_planes_on_card(dev):
    """Two identical campaigns through one preparation cache: the second
    prepares nothing and leaves the card's allocated memory where the first
    left it, and what the cache keeps (contexts, params, keys, data) is less
    than one (E, M, d) plane of the group's runs: the runs' states are made
    when a group runs and released with it."""
    from repro_torch.models import accuracy, init_mlp, mlp_logits, xent_loss
    from repro_torch.sim import CampaignSpec, CellSpec, Task, run_campaign
    from repro_torch.sim.plan import CompileCache

    gen = np.random.default_rng(0)
    m, per, e = 10, 20, 4
    cx = gen.standard_normal((m, per, 784)).astype(np.float32)
    cy = gen.integers(0, 10, (m, per)).astype(np.int64)
    test = {"x": gen.standard_normal((50, 784)).astype(np.float32), "y": gen.integers(0, 10, 50).astype(np.int64)}
    p0 = init_mlp(prng.key(0), hidden=128)
    d = 784 * 128 + 128 + 128 * 128 + 128 + 128 * 10 + 10

    def task_fn(cfg):
        return Task(p0, functools.partial(xent_loss, mlp_logits), functools.partial(accuracy, mlp_logits),
                    cx, cy, test, device=dev)

    spec = CampaignSpec(base=dict(n_clients=m, rounds=1, local_epochs=1, use_kernels=True),
                        cells=(CellSpec("a"), CellSpec("lr", {"lr": 0.02})), seeds=(0, 1))
    cache = CompileCache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    run_campaign(spec, task_fn, compile_cache=cache)
    torch.cuda.synchronize()
    after_first = torch.cuda.memory_allocated(dev)
    run_campaign(spec, task_fn, compile_cache=cache)
    torch.cuda.synchronize()
    assert cache.lowerings == 1 and cache.hits == 1
    assert torch.cuda.memory_allocated(dev) == after_first
    assert after_first - before < e * m * d * 4


def test_lm_leaf_wire_on_card_equals_plain_versions(dev):
    """B1 on one client's row of qwen2-1.5b's largest leaf (blocks[0].ffn.w1,
    385,351,680 coordinates, drawn in column blocks of the long row) and B3
    on the round's 4 stored rows, each against its plain version on the
    card."""
    from repro_torch.fl.pytree_wire import leaf_key

    d, m = 28 * 1_536 * 8_960, 4
    gen = torch.Generator(device=dev).manual_seed(12)
    key = leaf_key(prng.key(1, dev), 0)
    b = torch.tensor(0.01, device=dev)
    rows = torch.empty((m, ops.padded_len(d) // 8), dtype=torch.uint8, device=dev)
    for g in range(m):
        delta = 0.01 * torch.randn(1, d, generator=gen, device=dev)
        kp, _ = ops.stoch_quant_compress_batch(key, delta, b, row_offset=g, engine="cuda")
        rp, _ = ops.stoch_quant_compress_batch(key, delta, b, row_offset=g, engine="ref")
        assert torch.equal(kp, rp)
        rows[g] = kp[0]
        del delta, rp
    b_vec = torch.full((d,), 0.01, device=dev)
    got = ops.bit_aggregate(rows, b_vec, d, engine="cuda")
    assert torch.equal(got, ops.bit_aggregate(rows, b_vec, d, engine="ref"))
    assert bool((got.abs() <= 0.01).all())


@pytest.mark.parametrize("rand_bits,aggregator,launches", [
    (32, "probit_plus", {"stoch_quant_pack": 2 * 3 * 15, "bit_aggregate": 2 * 15}),
    (16, "probit_plus", {}),
    (32, "fedavg_fp32", {}),
])
def test_lm_round_on_kernels_equals_round_on_plain_versions(dev, rand_bits, aggregator, launches):
    """The federated LM round on the reduced qwen2 through the trainer's own
    set-up and step, two rounds of 3 clients: its launches (B1 a client and
    leaf, B3 a leaf, on the kernel wire only) and every round's parameters,
    b and losses equal to the engine="ref" step's."""
    from repro_torch import tree
    from repro_torch.launch import train
    from repro_torch.launch.fl_step import make_fl_train_step

    args = train.parse_args(["--arch", "qwen2-1.5b", "--reduced", "--clients", "3", "--seq", "32", "--rounds", "2",
                             "--rand-bits", str(rand_bits), "--aggregator", aggregator])
    run = train.setup(args)
    ref_step = make_fl_train_step(run.cfg, run.fl, engine="ref")
    params, b, key = run.params, torch.tensor(0.01, device=dev), prng.key(1, dev)
    got = {}
    for r in range(args.rounds):
        batch = train.round_batch(run, args, r)
        key, kr = prng.split(key, 2)
        _build.reset_launches()
        new, b_new, met = run.step(params, b, batch, kr)
        torch.cuda.synchronize()
        for k, v in _build.launches.items():
            got[k] = got.get(k, 0) + v
        _build.reset_launches()
        r_new, r_b, r_met = ref_step(params, b, batch, kr)
        assert not any(_build.launches.values())
        for x, y in zip(tree.leaves(new), tree.leaves(r_new)):
            assert torch.equal(x, y)
        assert b_new.item() == r_b.item()
        assert met["loss_first"].item() == r_met["loss_first"].item()
        assert met["loss_last"].item() == r_met["loss_last"].item()
        params, b = new, b_new
    assert {k: v for k, v in got.items() if v} == launches


@pytest.fixture
def deterministic(monkeypatch):
    """Deterministic algorithms for the test (the MoE's and the mLSTM's
    backward scatter-add), as ``chip_smoke.py`` runs."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "xlstm-350m", "jamba-1.5-large-398b", "hubert-xlarge",
                                  "pixtral-12b"])
def test_lm_new_family_round_on_kernels_equals_round_on_plain_versions(dev, deterministic, arch):
    """The federated LM round on the reduced llama4-scout (MoE top-1 with the
    shared expert, the f32 router), the reduced xLSTM (an mLSTM and an
    sLSTM block, the mLSTM over two chunks of 256 at seq 512), the reduced
    jamba (a Mamba position scanning two chunks of 256 at seq 512, an
    attention position with the MoE FFN), the reduced hubert (the audio
    stub, the encoder-only head) and the reduced pixtral (16 stub patches
    before 32 tokens) through the trainer's own set-up, batches and step,
    two rounds of 3 clients: B1 a client and leaf, B3 a leaf, and every
    round's parameters (the routers still f32), b and losses equal to the
    engine="ref" step's."""
    from repro_torch import tree
    from repro_torch.launch import train
    from repro_torch.launch.fl_step import make_fl_train_step

    seq = "512" if arch in ("xlstm-350m", "jamba-1.5-large-398b") else "32"
    args = train.parse_args(["--arch", arch, "--reduced", "--clients", "3", "--seq", seq, "--rounds", "2",
                             "--per-batch", "1"])
    run = train.setup(args)
    n_leaves = len(tree.leaves(run.params))
    ref_step = make_fl_train_step(run.cfg, run.fl, engine="ref")
    params, b, key = run.params, torch.tensor(0.01, device=dev), prng.key(1, dev)
    got = {}
    for r in range(args.rounds):
        batch = train.round_batch(run, args, r)
        key, kr = prng.split(key, 2)
        _build.reset_launches()
        new, b_new, met = run.step(params, b, batch, kr)
        torch.cuda.synchronize()
        for k, v in _build.launches.items():
            got[k] = got.get(k, 0) + v
        _build.reset_launches()
        r_new, r_b, r_met = ref_step(params, b, batch, kr)
        assert not any(_build.launches.values())
        for x, y, w in zip(tree.leaves(new), tree.leaves(r_new), tree.leaves(params)):
            assert x.dtype == w.dtype and torch.equal(x, y)
        assert b_new.item() == r_b.item()
        assert met["loss_first"].item() == r_met["loss_first"].item()
        assert met["loss_last"].item() == r_met["loss_last"].item()
        params, b = new, b_new
    assert {k: v for k, v in got.items() if v} == {"stoch_quant_pack": 3 * n_leaves * 2, "bit_aggregate": n_leaves * 2}
    routers = [w for p, w in tree.leaves_with_path(params) if p[-1] == "router"]
    assert len(routers) == (arch in ("llama4-scout-17b-a16e", "jamba-1.5-large-398b"))
    assert all(w.dtype == torch.float32 for w in routers)


def test_lm_round_refuses_a_cohort_whose_rows_exceed_free_memory(dev):
    """A cohort whose stored wire rows alone exceed the card's free memory
    is refused before the round starts: one leaf of 2^30 weights packs to
    128 MiB a client, and the cohort is larger than the card can hold."""
    from repro_torch.configs import get_config
    from repro_torch.launch.fl_step import DistFLConfig, make_fl_train_step

    d = 1 << 30
    m = torch.cuda.mem_get_info(dev)[0] // (d // 8) + 1
    step = make_fl_train_step(get_config("qwen2-1.5b"), DistFLConfig(clients_per_round=m))
    params = {"w": torch.zeros(d, dtype=torch.bfloat16, device=dev)}
    batch = {"x": torch.zeros(1, 1, 1, 1, 2, device=dev).expand(m, 1, 1, 1, 2)}
    with pytest.raises(MemoryError, match="wire rows"):
        step(params, torch.tensor(0.01, device=dev), batch, prng.key(1, dev))


def _serve_models(arch):
    """The reduced ``arch`` in f32 on the CPU (the port's init) and its copy
    on the card."""
    from repro_torch import configs, tree
    from repro_torch.models import build_specs, init_params

    cfg = configs.reduced(configs.get_config(arch))
    cpu = tree.tree_map(lambda w: w.float(), init_params(build_specs(cfg), prng.key(0)))
    return cfg, cpu, tree.tree_map(lambda w: w.cuda(), cpu)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "xlstm-350m"])
def test_serve_step_on_card_equals_cpu_run(dev, f32_convolutions, arch):
    """serve_step over 8 positions on the card against the same steps on the
    CPU, f32 parameters, each carrying its own caches: logits within 5e-3
    absolute (the bf16 KV cache turns an f32 ulp into a bf16 step now and
    then, as against the reference; tests/test_torch_decode.py), the
    recurrent f32 states within 1e-4 of their largest entries and the bf16
    leaves within one bf16 step. The serving path launches no kernel."""
    from repro_torch import tree
    from repro_torch.models import init_cache, serve_step

    cfg, cpu, card = _serve_models(arch)
    toks = prng.randint(prng.key(5), (2, 8), 0, cfg.vocab)
    c_cpu, c_card = init_cache(cfg, 2, 8), init_cache(cfg, 2, 8, dev)
    _build.reset_launches()
    for t in range(8):
        want, c_cpu = serve_step(cpu, c_cpu, {"tokens": toks[:, t : t + 1]}, t, cfg)
        got, c_card = serve_step(card, c_card, {"tokens": toks[:, t : t + 1].to(dev)}, t, cfg)
        assert got.device.type == "cuda" and torch.isfinite(got).all()
        assert (got.cpu() - want).abs().max() <= 5e-3
    assert not any(_build.launches.values())
    for w, g in zip(tree.leaves(c_cpu), tree.leaves(c_card)):
        assert g.dtype == w.dtype and g.device.type == "cuda"
        rel = ((g.cpu().float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= (2.0**-7 if w.dtype == torch.bfloat16 else 1e-4)


def test_serve_engine_on_card_equals_cpu_engine(dev, f32_convolutions):
    """The engine on the card gives the CPU engine's greedy tokens and its
    T = 0.8 sampled tokens (the gumbel draws are the same bits on both),
    3 prompts over a batch of 2, f32 reduced qwen2; argmax ties go to the
    first index on the card as on the CPU."""
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg, cpu, card = _serve_models("qwen2-1.5b")
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    for temperature in (0.0, 0.8):
        sc = ServeConfig(batch_size=2, max_len=32, max_new_tokens=5, temperature=temperature)
        want = ServingEngine(cfg, cpu, sc).generate(prompts, seed=0)
        eng = ServingEngine(cfg, card, sc)
        assert eng.generate(prompts, seed=0) == want
        assert eng.generate(prompts, seed=0) == want
    ties = torch.zeros(3, cfg.vocab, device=dev)
    ties[0, [cfg.vocab - 1, 17, 300]] = 1.0
    ties[1, :] = -2.0
    ties[2, [5, 4]] = 3.0
    assert torch.argmax(ties, dim=-1).tolist() == [17, 0, 4]
    g = torch.Generator().manual_seed(0)
    wide = torch.randint(0, 4, (8, 151_936), generator=g).float()
    assert torch.equal(torch.argmax(wide.to(dev), dim=-1).cpu(), torch.argmax(wide, dim=-1))


def test_stream_shard_over_two_ranks_on_card_equals_one_process(dev, deterministic, tmp_path):
    """Two gloo ranks sharing the card run a stream_shard round of 6
    stateless clients, 3 a rank in one chunk, through the kernels: each
    rank's estimate, loss and b equal the one-process round's (the same
    chunks) bit for bit, with one B1 a round and one B4 a local step on
    each rank."""
    import warnings

    from _torch_ranks import run_ranks
    from repro_torch.fl import FLConfig, FLSimulation
    from repro_torch.models import accuracy, mlp_logits, xent_loss

    p0, cx, cy, test = _mlp_task()
    cfg = dict(n_clients=6, rounds=2, local_epochs=2, use_kernels=True, client_chunk=3, stateless_clients=True,
               stream_shard=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # one process: the one-device no-op
        sim = FLSimulation(FLConfig(**cfg), p0, functools.partial(xent_loss, mlp_logits),
                           functools.partial(accuracy, mlp_logits), cx, cy, test, device=dev)
    want = [{k: v.cpu() for k, v in m.items()} for _, m in sim.iter_rounds()]
    for r in run_ranks(2, tmp_path, "fl_run", cfg=cfg, task=(p0, cx, cy, test), rounds=2, device="cuda"):
        assert r["ranks"] == 2 and r["client_rows"] == 3
        assert r["launches"] == {"stoch_quant_pack": 2, "prox_sgd": 8}
        assert torch.equal(r["w_global"], sim.w_global.cpu())
        for a, c in zip(r["metrics"], want):
            assert all(torch.equal(a[k], c[k]) for k in ("theta", "loss", "b"))


def test_pod_axis_step_on_card_equals_one_process(dev, deterministic, tmp_path):
    """The reduced qwen2's LM step with 4 clients as (2 steps, 2 pods): over
    a ("pod",) mesh of two gloo ranks sharing the card, each rank's new
    parameters, b and losses equal the one-process step's bit for bit; each
    rank launches B1 once a (client, leaf) for its 2 clients and B3 once a
    leaf over all 4 clients' gathered rows."""
    from _torch_ranks import run_ranks
    from repro_torch import configs, tree
    from repro_torch.data import make_lm_streams
    from repro_torch.launch import fl_step
    from repro_torch.models import build_specs, init_params

    cfg = configs.reduced(configs.get_config("qwen2-1.5b"))
    params = init_params(build_specs(cfg), prng.key(0))
    toks = np.stack([s.reshape(2, 2, 17) for s in make_lm_streams(0, 4, cfg.vocab, 17, 4)]).reshape(2, 2, 2, 2, 17)
    t = torch.from_numpy(toks)
    batch = {"tokens": t[..., :-1], "labels": t[..., 1:]}
    _, kr = prng.split(prng.key(1), 2)
    fl = dict(clients_per_round=4, local_steps=2)
    step = fl_step.make_fl_train_step(cfg, fl_step.DistFLConfig(**fl))
    new, b, m = step(tree.tree_map(lambda w: w.to(dev), params), torch.tensor(0.01, device=dev),
                     tree.tree_map(lambda x: x.to(dev), batch), kr.to(dev))
    n_leaves = len(tree.leaves(new))
    for r in run_ranks(2, tmp_path, "lm_pod_step", cfg=cfg, params=params, batch=batch, b=0.01, key=kr, fl=fl,
                       device="cuda"):
        assert all(torch.equal(a, c.cpu()) for a, c in zip(r["params"], tree.leaves(new)))
        assert r["b"] == float(b) and r["metrics"] == {k: float(v) for k, v in m.items()}
        assert r["launches"] == {"stoch_quant_pack": 2 * n_leaves, "bit_aggregate": n_leaves}


# The model-axis card test's f32 bars: shares of the largest value (logits,
# the MoE sum), an rtol of the losses and a share of the coordinates apart.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W (both ranks alike): logits
# 2.54e-5 (cuBLAS sums the vocabulary's and the heads' shorter sharded
# products in another order), the MoE sum 0 (its bar is the CPU test's),
# losses 7.2e-8 and 6.3e-7, 6.2e-6 of the coordinates apart.
MODEL_AXIS_F32_BARS = {"logits": 1e-4, "moe_sum": 1e-6, "loss_rtol": 5e-6, "apart": 5e-5}


def test_model_axis_step_on_card_equals_one_process(dev, deterministic, tmp_path):
    """The reduced qwen3-moe in f32 on a ("data", "model") = (1, 2) mesh of
    two ranks sharing the card (the host-staged backend carries DTensor's
    own collectives), against one process on the card, with the bars
    MODEL_AXIS_F32_BARS (each a few times the gap measured on an H100, in
    its comment): each rank's prefill logits and the first MoE block's
    expert-parallel f32 sum (before its rounding) within a share of the
    largest value, its b exact, its losses within an rtol and its new
    parameters with at most a share of the coordinates apart; its shard of
    the largest leaf's wire, unpacked, equal to the whole wire's bits
    coordinate for coordinate; and each rank's launches: B1 once a
    (client, leaf) of the leaves it holds, every leaf, and B3 once a
    leaf. The gaps are printed as one JSON line."""
    import dataclasses
    import json

    from _torch_ranks import run_ranks
    from repro_torch import configs, distributed, tree
    from repro_torch.core.quantizer import unpack_bits
    from repro_torch.launch import fl_step
    from repro_torch.models import build_specs, init_params, layers, moe, prefill, sample_batch
    from repro_torch.models.spec import is_spec

    cfg = configs.reduced(configs.get_config("qwen3-moe-30b-a3b"))
    specs = tree.tree_map(lambda s: dataclasses.replace(s, dtype=torch.float32), build_specs(cfg), is_leaf=is_spec)
    params = init_params(specs, prng.key(0, dev))
    batch = sample_batch(cfg, 2, 32, "prefill", seed=1)
    sb = sample_batch(cfg, 16, 32, "train", seed=2)
    step_batch = {k: v.view((2, 2, 2, 2) + v.shape[1:]) for k, v in sb.items()}
    fl, key = dict(clients_per_round=4, local_steps=2, lr=0.01), prng.key(5)
    leaves = tree.leaves(params)
    li = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    delta = torch.randn(leaves[li].shape, generator=torch.Generator().manual_seed(0)) * 0.01
    with torch.no_grad():
        logits = prefill(params, {k: v.to(dev) for k, v in batch.items()}, cfg).cpu()
        x2d = layers.embed_tokens(params["embed"], batch["tokens"].to(dev)).reshape(-1, cfg.d_model)
        p = {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}
        gates, idx = moe._route(x2d, p["router"], cfg.top_k)
        moe_sum = moe._expert_sum(x2d, gates, idx, p["w1"], p["w3"], p["w2"], moe.capacity(x2d.shape[0], cfg),
                                  cfg.n_experts).cpu()
    step = fl_step.make_fl_train_step(cfg, fl_step.DistFLConfig(**fl))
    wire, _ = step.pipeline.compressor.compress(prng.key(7, dev), delta.to(dev).reshape(1, -1),
                                                torch.tensor(0.01, device=dev), torch.zeros((), device=dev),
                                                row_offset=3)
    bits = (unpack_bits(wire.packed[0].cpu(), delta.numel()) > 0).view(delta.shape)
    new, b, met = step(params, torch.tensor(0.01, device=dev), {k: v.to(dev) for k, v in step_batch.items()},
                       key.to(dev))
    n = sum(w.numel() for w in tree.leaves(new))
    ranks = run_ranks(2, tmp_path, "model_axis", timeout=600, backend=distributed.STAGED_BACKEND, cfg=cfg,
                      specs=specs, batch=batch, step_batch=step_batch, b=0.01, key=key, fl=fl, wire_leaf=li,
                      wire_delta=delta, device_type="cuda")
    gaps = [{"logits": float((r["logits"] - logits).abs().max() / logits.abs().max()),
             "moe_sum": float((r["moe_sum"] - moe_sum).abs().max() / moe_sum.abs().max()),
             **{k: abs(r["metrics"][k] / float(met[k]) - 1) for k in ("loss_first", "loss_last")},
             "apart": sum(int((a != c.cpu()).sum()) for a, c in zip(r["params_new"], tree.leaves(new))) / n}
            for r in ranks]
    print(json.dumps({"model_axis_f32_gaps": gaps}))
    bars = MODEL_AXIS_F32_BARS
    for r, gap in zip(ranks, gaps):
        assert gap["logits"] <= bars["logits"] and gap["moe_sum"] <= bars["moe_sum"], gap
        assert r["b"] == float(b)
        assert max(gap["loss_first"], gap["loss_last"]) <= bars["loss_rtol"], gap
        assert gap["apart"] <= bars["apart"], gap
        off, local = r["wire_offset"], r["wire_bits"]
        assert torch.equal(local, bits[tuple(slice(o, o + s) for o, s in zip(off, local.shape))])
        assert r["launches"] == {"stoch_quant_pack": 4 * len(leaves), "bit_aggregate": len(leaves)}
