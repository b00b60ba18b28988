"""The port's kernel dispatch (repro_torch.kernels.ops) on the CPU against
the JAX package's: the plain versions the CUDA kernels are held to on the
card must themselves equal the reference.

JAX side: ``engine="ref"``, which the repo's own kernel tests hold
bit-identical to Pallas, and ``engine="interpret"`` at tiny sizes only.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.bit_aggregate import bit_aggregate as bit_aggregate_wrapper  # noqa: E402
from repro_torch.kernels.prox_sgd import prox_sgd as prox_sgd_wrapper  # noqa: E402
from repro_torch.kernels.stoch_quant import stoch_quant_ef, stoch_quant_pack  # noqa: E402


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_resolve_engine_policy():
    assert ops.resolve_engine(None, torch.device("cpu")) == "ref"
    assert ops.resolve_engine(None, torch.device("cuda")) == "cuda"
    assert ops.resolve_engine("ref", torch.device("cuda")) == "ref"
    assert ops.resolve_engine("cuda", torch.device("cpu")) == "cuda"
    with pytest.raises(ValueError):
        ops.resolve_engine("pallas")


@pytest.mark.parametrize("d", [997, 1024, 40522])
def test_padded_len(d):
    assert ops.padded_len(d) == jops.padded_len(d)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("d,m", [(997, 5), (8193, 3), (40522, 9)])
def test_stoch_quant_compress_batch_vs_jax_ref(d, m, ef):
    """Kernel-width wire bytes (padded_len(d)/8) and EF residuals. The
    reference compressor adds the residual before calling ops; the port
    passes it in (the kernel fuses the add) — same f32 sum."""
    deltas = _rand((m, d), d, 0.02)
    res = _rand((m, d), d + 1, 0.005)
    b = np.full((d,), 0.01, np.float32)
    eff = deltas + res if ef else deltas
    jp, jr = jops.stoch_quant_compress_batch(
        jax.random.PRNGKey(4), eff, b, row_offset=2, want_residual=ef, engine="ref"
    )
    tp, tr = ops.stoch_quant_compress_batch(
        prng.key(4), torch.from_numpy(deltas), torch.from_numpy(b),
        residual=torch.from_numpy(res) if ef else None, row_offset=2, want_residual=ef,
    )
    assert tp.shape == (m, ops.padded_len(d) // 8)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    if ef:
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


@pytest.mark.parametrize("ef", [False, True])
def test_stoch_quant_compress_batch_vs_jax_interpret(ef):
    """Against the Pallas kernels themselves, in interpret mode (tiny size)."""
    d, m = 1500, 3
    deltas = _rand((m, d), 5, 0.02)
    b = np.full((d,), 0.012, np.float32)
    jp, jr = jops.stoch_quant_compress_batch(
        jax.random.PRNGKey(6), deltas, b, want_residual=ef, engine="interpret"
    )
    tp, tr = ops.stoch_quant_compress_batch(
        prng.key(6), torch.from_numpy(deltas), torch.from_numpy(b), want_residual=ef
    )
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    if ef:
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


@pytest.mark.parametrize(
    "n,m", [(1024, 1), (5000, 16), (997, 5), (4096, 300), (997, 255), (997, 256), (997, 257), (2048, 1000)]
)
def test_bit_aggregate_vs_jax_ref(n, m):
    """theta_hat bit for bit, M = 300 included (a uint8 count would wrap),
    and M around the reference's 256-client tile."""
    rng = np.random.default_rng(n + m)
    packed = rng.integers(0, 256, (m, ops.padded_len(n) // 8), dtype=np.uint8)
    b = np.abs(rng.standard_normal(n)).astype(np.float32)
    want = np.asarray(jops.bit_aggregate(packed, b, n, engine="ref"))
    got = ops.bit_aggregate(torch.from_numpy(packed), torch.from_numpy(b), n)
    np.testing.assert_array_equal(want, got.numpy())


def test_bit_aggregate_vs_jax_interpret():
    n, m = 2048, 3
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 256, (m, n // 8), dtype=np.uint8)
    b = np.abs(rng.standard_normal(n)).astype(np.float32)
    want = np.asarray(jops.bit_aggregate(packed, b, n, engine="interpret"))
    got = ops.bit_aggregate(torch.from_numpy(packed), torch.from_numpy(b), n)
    np.testing.assert_array_equal(want, got.numpy())


def test_bit_aggregate_m257_vs_jax_interpret():
    """M = 257: the Pallas kernel's second client tile holds one client."""
    n, m = 997, 257
    rng = np.random.default_rng(257)
    packed = rng.integers(0, 256, (m, ops.padded_len(n) // 8), dtype=np.uint8)
    b = np.abs(rng.standard_normal(n)).astype(np.float32)
    want = np.asarray(jops.bit_aggregate(packed, b, n, engine="interpret"))
    got = ops.bit_aggregate(torch.from_numpy(packed), torch.from_numpy(b), n)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("m,n", [(1, 8), (7, 997), (65, 997), (257, 5000), (500, 997), (1000, 2048), (2000, 1)])
def test_bit_aggregate_geometry_tiles_and_streams(m, n):
    """The tiles cover the ceil(n/8) wire bytes that hold coordinates and
    none lies wholly beyond them; the cluster is a launchable size, and it
    stays at one block a tile until a row stream would take more than
    STREAM_ROWS rows, and then is the smallest that keeps it there (or
    MAX_CLUSTER)."""
    b3 = importlib.import_module("repro_torch.kernels.bit_aggregate")  # the binding, not kernels.bit_aggregate

    tiles, cluster = b3.launch_geometry(m, n)
    assert tiles * b3.TILE_BYTES >= -(-n // 8) > (tiles - 1) * b3.TILE_BYTES
    assert cluster in (1, 2, 4, 8) and cluster <= b3.MAX_CLUSTER
    rows_per_stream = [-(-m // (c * b3.WARPS)) for c in (cluster, max(cluster // 2, 1))]
    assert cluster == b3.MAX_CLUSTER or rows_per_stream[0] <= b3.STREAM_ROWS
    assert cluster == 1 or rows_per_stream[1] > b3.STREAM_ROWS


@pytest.mark.parametrize(
    "m,cluster", [(1, 1), (100, 1), (384, 1), (385, 2), (768, 2), (1000, 4), (1537, 8), (10_000, 8), (2**24 - 1, 8)]
)
def test_bit_aggregate_geometry_follows_the_cohort(m, cluster):
    """At the main path's wire (P = 14,848 bytes): one block a column tile
    while a row stream takes at most 96 rows (M = 100: the launch and one
    round of loads bound the time, and one block a tile measured fastest),
    then 2, 4 and 8 blocks; from M = 1,000 on at least two blocks per SM
    of the H100 (132)."""
    from repro_torch.kernels.bit_aggregate import launch_geometry

    tiles, got = launch_geometry(m, 118_282)
    assert (tiles, got) == (14_848 // 128, cluster)
    if m >= 1000:
        assert tiles * got >= 2 * 132


def test_bit_aggregate_wrapper_takes_b_at_length_n():
    """The wrapper's plain version at n < 8P, into a given buffer too."""
    n, m = 997, 9
    rng = np.random.default_rng(5)
    packed = torch.from_numpy(rng.integers(0, 256, (m, 128), dtype=np.uint8))
    b = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32))
    want = ref.bit_aggregate_ref(packed, b)
    assert want.shape == (n,)
    assert torch.equal(bit_aggregate_wrapper(packed, b), want)
    buf = torch.full((1024,), float("nan"))
    assert torch.equal(bit_aggregate_wrapper(packed, b, out=buf[:n]), want)
    assert torch.equal(buf[:n], want) and bool(buf[n:].isnan().all())


def test_bit_aggregate_padded_tail_never_leaks():
    """tests/test_kernels.py's poison case: n % 8 != 0, M % 8 != 0, all-ones
    pad bits must not reach theta_hat[:n]; and the result equals JAX's."""
    n, m = 997, 5
    pbytes = ops.padded_len(n) // 8
    rng = np.random.default_rng(11)
    packed = rng.integers(0, 256, (m, pbytes), dtype=np.uint8)
    b = np.abs(rng.standard_normal(n)).astype(np.float32)
    base = ops.bit_aggregate(torch.from_numpy(packed), torch.from_numpy(b), n)
    poisoned = packed.copy()
    full = n // 8
    poisoned[:, full] |= (0xFF << (8 - (8 * (full + 1) - n))) & 0xFF
    poisoned[:, full + 1:] = 0xFF
    got = ops.bit_aggregate(torch.from_numpy(poisoned), torch.from_numpy(b), n)
    np.testing.assert_array_equal(base.numpy(), got.numpy())
    want = np.asarray(jops.bit_aggregate(jnp.asarray(poisoned), b, n, engine="ref"))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("use_kernels", [False, True])
def test_server_count_protocol_in_client_chunks(use_kernels):
    """Vote counts folded in over client chunks finalize to the JAX server's
    estimate (its division by M compiled under jit, as the round runs it),
    and the one-shot aggregate of the whole wire gives the same."""
    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation as tagg

    n, m, splits = 997, 7, ((0, 3), (3, 7))
    rng = np.random.default_rng(13)
    packed = rng.integers(0, 256, (m, ops.padded_len(n) // 8), dtype=np.uint8)
    b = np.abs(rng.standard_normal(n)).astype(np.float32)
    jserver = jagg.ProBitPlusServer()
    jcounts = jserver.init_counts(packed.shape[1])
    for lo, hi in splits:
        jcounts = jserver.accumulate_counts(jcounts, jnp.asarray(packed[lo:hi]))
    want = np.asarray(jax.jit(lambda c, bb: jserver.finalize(c, m, bb))(jcounts, b))

    server = tagg.ProBitPlusServer(use_kernels=use_kernels)
    counts = server.init_counts(packed.shape[1])
    for lo, hi in splits:
        counts = server.accumulate_counts(counts, torch.from_numpy(packed[lo:hi]))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(want, server.finalize(counts, m, torch.from_numpy(b)).numpy())
    wire = tagg.PackedWire(packed=torch.from_numpy(packed), b=torch.from_numpy(b), d=n)
    np.testing.assert_array_equal(want, server.aggregate(wire).numpy())


@pytest.mark.parametrize("shared_w0", [False, True])
@pytest.mark.parametrize("n", [1024, 3333])
def test_prox_sgd(n, shared_w0):
    """Exact against the separate-op f32 formula. Against JAX within two
    roundings of each term: XLA on the CPU contracts lam*(w - w0) + grad
    and w - eta*m' into fused multiply-adds, the port (and its kernel)
    rounds every operation."""
    m = 4
    w, g = _rand((m, n), 1), _rand((m, n), 2)
    mom = _rand((m, n), 3, 0.1)
    w0 = 0.9 * w[0] if shared_w0 else 0.9 * w
    eta, lam, mu = 0.01, 0.2, 0.5
    tw, tm = ops.prox_sgd(*(torch.from_numpy(x) for x in (w, w0, g, mom)), ops.prox_coeffs(eta, lam, mu))
    f32 = np.float32
    gt = g + f32(lam) * (w - w0)
    nm = f32(mu) * mom + gt
    np.testing.assert_array_equal(tm.numpy(), nm)
    np.testing.assert_array_equal(tw.numpy(), w - f32(eta) * nm)
    jw, jm = jax.vmap(lambda *a: jops.prox_sgd(*a, eta, lam, mu, engine="ref"))(
        w, np.broadcast_to(w0, w.shape), g, mom
    )
    eps = np.finfo(np.float32).eps
    tol_m = 2 * eps * (np.abs(g) + np.abs(f32(lam) * (w - w0)) + np.abs(f32(mu) * mom))
    tol_w = 2 * eps * (np.abs(w) + f32(eta) * (np.abs(nm) + tol_m))
    assert np.all(np.abs(np.asarray(jm) - tm.numpy()) <= tol_m)
    assert np.all(np.abs(np.asarray(jw) - tw.numpy()) <= tol_w)


def _b4_units(m, d, geometry):
    """The (rows, columns) slices of B4's units, in the order the kernel
    numbers them (csrc/prox_sgd.cu: tile first), and the CTA that takes
    each (unit u goes to CTA u % ctas, grid-stride)."""
    tile, rows, ctas = geometry
    tiles = -(-d // tile)
    for u in range(tiles * -(-m // rows)):
        t, g = u % tiles, u // tiles
        yield u % ctas, slice(g * rows, min(m, (g + 1) * rows)), slice(t * tile, min(d, (t + 1) * tile))


@pytest.mark.parametrize("bps", [1, 3, 8])
@pytest.mark.parametrize("m,d", [(1, 1), (1, 997), (7, 4099), (100, 40_522), (3, 2048), (5, 6145), (100, 118_282)])
def test_prox_sgd_geometry_covers_every_element_once(m, d, bps):
    """launch_geometry's units tile the (M, d) cohort: every element lies in
    exactly one unit, and every unit has one CTA within CUDA's grid limit."""
    from repro_torch.kernels.prox_sgd import launch_geometry

    geometry = launch_geometry(m, d, 132, bps)
    tile, rows, ctas = geometry
    assert tile & (tile - 1) == 0 and 4 <= tile <= 8192 and 1 <= rows <= m and 1 <= ctas < 2**31
    count = np.zeros((m, d), np.int8)
    for cta, r, c in _b4_units(m, d, geometry):
        assert 0 <= cta < ctas
        count[r, c] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("bps", [2, 3, 4, 8])
@pytest.mark.parametrize("m,d", [(100, 118_282), (100, 11_172_042), (1_000, 1_117_204), (10_000, 111_720)])
def test_prox_sgd_geometry_fills_the_card_and_reads_w0_once_a_group(m, d, bps):
    """At the main path's shapes and the sweep's: at least one whole wave of
    CTAs over the H100's 132 SMs, units of 2,048-4,096 elements (the size
    that streamed fastest on the card), the columns and rows of the units
    adding up to the cohort, and w0's slice read once per (tile, row group):
    ceil(M / rows) reads of w0 in all, one while w0 stays in L2 (rows of
    one, the re-reads hit L2) and at most M / ROWS beyond it."""
    from repro_torch.kernels.prox_sgd import ROWS, W0_L2_BYTES, launch_geometry

    tile, rows, ctas = launch_geometry(m, d, 132, bps)
    tiles, groups = -(-d // tile), -(-m // rows)
    assert ctas == tiles * groups >= 132 * bps
    assert 2048 <= tile * rows <= 4096
    assert sum(min(tile, d - t * tile) for t in range(tiles)) == d
    assert sum(min(rows, m - g * rows) for g in range(groups)) == m
    w0_stages = tiles * groups  # one per unit, each of one tile's slice
    assert w0_stages / tiles == groups == (m if 4 * d <= W0_L2_BYTES else -(-m // ROWS))


@pytest.mark.parametrize("shared_w0", [False, True])
def test_prox_sgd_in_place_equals_out_of_place(shared_w0):
    """ops.prox_sgd with out= aliasing w and the momentum (the local loop's
    in-place update) equals the out-of-place result bit for bit, returns
    the out buffers, and still matches JAX's prox_sgd within test_prox_sgd's
    tolerance; the kernel wrapper's plain version takes out= too."""
    m, n = 4, 3333
    w, g = _rand((m, n), 1), _rand((m, n), 2)
    mom = _rand((m, n), 3, 0.1)
    w0 = 0.9 * w[0] if shared_w0 else 0.9 * w
    eta, lam, mu = 0.01, 0.2, 0.5
    tw, tg, tm, tw0 = (torch.from_numpy(x.copy()) for x in (w, g, mom, w0))
    coeffs = ops.prox_coeffs(eta, lam, mu)
    want_w, want_m = ops.prox_sgd(tw, tw0, tg, tm, coeffs)
    for prox in (ops.prox_sgd, prox_sgd_wrapper):
        w_io, m_io = tw.clone(), tm.clone()
        got = prox(w_io, tw0, tg, m_io, coeffs, out=(w_io, m_io))
        assert got[0] is w_io and got[1] is m_io
        assert torch.equal(w_io, want_w) and torch.equal(m_io, want_m)
    fresh = (torch.empty_like(tw), torch.empty_like(tw))
    assert ops.prox_sgd(tw, tw0, tg, tm, coeffs, out=fresh, engine="ref")[0] is fresh[0]
    assert torch.equal(fresh[0], want_w) and torch.equal(fresh[1], want_m)
    assert torch.equal(tw, torch.from_numpy(w)) and torch.equal(tm, torch.from_numpy(mom))
    jw, jm = jax.vmap(lambda *a: jops.prox_sgd(*a, eta, lam, mu, engine="ref"))(
        w, np.broadcast_to(w0, w.shape), g, mom
    )
    f32, eps = np.float32, np.finfo(np.float32).eps
    nm = want_m.numpy()
    tol_m = 2 * eps * (np.abs(g) + np.abs(f32(lam) * (w - w0)) + np.abs(f32(mu) * mom))
    tol_w = 2 * eps * (np.abs(w) + f32(eta) * (np.abs(nm) + tol_m))
    assert np.all(np.abs(np.asarray(jm) - nm) <= tol_m)
    assert np.all(np.abs(np.asarray(jw) - want_w.numpy()) <= tol_w)


def test_prox_sgd_out_rejects_other_aliases():
    """out= may alias only w (w_out) and the momentum (m_out); any other
    overlap, a swapped pair, one buffer for both, or a wrong shape raises."""
    m, n = 3, 64
    w, g, mom = (torch.from_numpy(_rand((m, n), s)) for s in (1, 2, 3))
    w0_full = torch.from_numpy(_rand((m, n), 4))
    buf = torch.zeros(2 * m * n)
    bad = [
        (w, (mom, w)),  # swapped
        (w, (w, w)),  # one buffer for both
        (w, (g, mom)),  # w_out over grad
        (w, (w, g)),  # m_out over grad
        (w[0], (w, mom)),  # w_out over a shared w0 row
        (w0_full, (w0_full, mom)),  # w_out over a full w0
        (w, (buf[1:m * n + 1].view(m, n), buf[m * n:].view(m, n))),  # the two overlap by one element
        (w, (torch.zeros(m, n + 1), mom)),  # shape
        (w, (w, torch.zeros(m, n, dtype=torch.float64))),  # dtype
    ]
    for w0, out in bad:
        for prox in (ops.prox_sgd, prox_sgd_wrapper):
            with pytest.raises(ValueError):
                prox(w, w0.contiguous(), g, mom, ops.prox_coeffs(0.01, 0.2, 0.5), out=out)


def test_wrappers_take_plain_version_on_cpu_tensors():
    """A kernel wrapper given CPU tensors computes the plain version and
    launches nothing."""
    _build.reset_launches()
    d_pad, m = 2048, 3
    delta = torch.from_numpy(_rand((m, d_pad), 1, 0.02))
    res = torch.from_numpy(_rand((m, d_pad), 2, 0.005))
    u = torch.rand(m, d_pad, generator=torch.Generator().manual_seed(0))
    b = torch.full((d_pad,), 0.01)
    assert torch.equal(stoch_quant_pack(delta, b, u), ref.stoch_quant_compress_ref(delta, b, u)[0])
    got = stoch_quant_ef(delta, res, b, u)
    want = ref.stoch_quant_compress_ref(delta, b, u, res, want_residual=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    packed = got[0]
    assert torch.equal(bit_aggregate_wrapper(packed, b), ref.bit_aggregate_ref(packed, b))
    w = delta[:, :1000].contiguous()
    coeffs = ops.prox_coeffs(0.01, 0.2, 0.5)
    pw = prox_sgd_wrapper(w, w[0].contiguous(), w, w, coeffs)
    rw = ref.prox_sgd_ref(w, w[0], w, w, coeffs)
    assert torch.equal(pw[0], rw[0]) and torch.equal(pw[1], rw[1])
    assert sum(_build.launches.values()) == 0


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        stoch_quant_pack(torch.zeros(2, 12), torch.zeros(12), torch.zeros(2, 12))  # 12 % 8
    with pytest.raises(ValueError):
        stoch_quant_pack(torch.zeros(2, 16, dtype=torch.float64), torch.zeros(16), torch.zeros(2, 16))
    wire = torch.zeros(2, 4, dtype=torch.uint8)
    for bad_b in (torch.zeros(33), torch.zeros(0), torch.zeros(2, 8), torch.zeros(31, dtype=torch.float64)):
        with pytest.raises(ValueError):
            bit_aggregate_wrapper(wire, bad_b)  # b: 1 <= n <= 8P, 1-D f32
    with pytest.raises(ValueError):
        bit_aggregate_wrapper(wire, torch.zeros(31), out=torch.zeros(32))
    with pytest.raises(ValueError):
        bit_aggregate_wrapper(torch.zeros(2, 4, 1, dtype=torch.uint8), torch.zeros(31))
    with pytest.raises(ValueError):
        prox_sgd_wrapper(torch.zeros(2, 5), torch.zeros(4), torch.zeros(2, 5), torch.zeros(2, 5),
                         ops.prox_coeffs(0.1, 0.1, 0.1))


def test_build_dir_is_the_checkout_or_the_variable(monkeypatch, tmp_path):
    """Kernels build inside the source checkout unless a directory is named."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert _build.build_dir() == root / "build" / "torch_ext"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "ext"))
    assert _build.build_dir() == (tmp_path / "ext").resolve()
