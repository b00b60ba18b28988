"""The port's public surface against the reference's, on the CPU.

Every name that a reference subpackage exports (its ``__init__``'s
``__all__``; for ``repro.distributed``, which has none, its public
functions) resolves in the port's counterpart, except the short list of
JAX-only names below, each with the port's counterpart. Then the pieces of
that surface this slice added: the attack registry (``available_attacks``
as the reference spells and orders it, ``get_attack`` as
``apply_attack(attack_id(name), ...)``), ``partition_dirichlet``,
``sgd_momentum_init`` / ``sgd_momentum_step`` and the single-client kernel
entries ``stoch_quant_compress`` / ``stoch_quant_pack`` on the plain
engine, against the reference's ``engine="ref"`` bytes and residuals.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro  # noqa: E402
import repro.core as rc  # noqa: E402
import repro.data as rd  # noqa: E402
import repro.optim as ro  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import kernels, prng  # noqa: E402
from repro_torch.core import apply_attack, attack_id, available_attacks, get_attack  # noqa: E402
from repro_torch.data import partition_dirichlet  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.optim import sgd_momentum_init, sgd_momentum_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_round import _one_torch_thread  # noqa: E402,F401

SUBPACKAGES = ("checkpoint", "configs", "core", "data", "distributed", "fl", "kernels", "launch", "models", "optim",
               "serving", "sim")

# Names of the reference that are JAX objects, with the port's counterpart
# in the same subpackage.
JAX_ONLY = {("distributed", "named_sharding"): "placements_for"}


def _reference_names(mod) -> list:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and inspect.isfunction(v) and v.__module__ == mod.__name__)


def test_the_subpackage_list_is_the_references():
    assert sorted(m.name for m in pkgutil.iter_modules(repro.__path__)) == sorted(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_reference_name_resolves_in_the_port(sub):
    ref_mod = importlib.import_module(f"repro.{sub}")
    port_mod = importlib.import_module(f"repro_torch.{sub}")
    names = _reference_names(ref_mod)
    assert names, sub
    missing = [n for n in names if not hasattr(port_mod, JAX_ONLY.get((sub, n), n))]
    assert not missing, f"repro_torch.{sub} lacks {missing}"


def test_jax_only_counterparts_exist():
    for (sub, name), port_name in JAX_ONLY.items():
        assert hasattr(importlib.import_module(f"repro.{sub}"), name)
        assert callable(getattr(importlib.import_module(f"repro_torch.{sub}"), port_name))


def test_kernels_stoch_quant_pack_is_the_ops_entry():
    """The package's ``stoch_quant_pack`` is the single-client entry, as the
    reference's; the launch wrapper keeps its module path."""
    assert kernels.stoch_quant_pack is kernels.ops.stoch_quant_pack
    assert kernels.stoch_quant_compress is kernels.ops.stoch_quant_compress
    from repro_torch.kernels import stoch_quant

    assert stoch_quant.stoch_quant_pack is not kernels.stoch_quant_pack
    assert repro_torch.kernels.stoch_quant is stoch_quant


def test_available_attacks_equals_reference():
    assert available_attacks() == rc.available_attacks()


@pytest.mark.parametrize("name", rc.available_attacks())
def test_get_attack_equals_apply_attack(name):
    key = prng.key(5)
    upd = 0.01 * prng.normal(prng.key(6), (10, 37))
    got = get_attack(name)(key, upd, 3)
    assert torch.equal(got, apply_attack(attack_id(name), key, upd, 3))


@pytest.mark.parametrize("alpha,seed", [(0.3, 0), (1.0, 4)])
def test_partition_dirichlet_equals_reference(alpha, seed):
    y = np.random.default_rng(2).integers(0, 10, 600)
    want = rd.partition_dirichlet(y, 9, 40, alpha=alpha, seed=seed)
    got = partition_dirichlet(y, 9, 40, alpha=alpha, seed=seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sgd_momentum_step_equals_reference():
    rng = np.random.default_rng(3)

    def tree():
        def f(shape):
            return rng.standard_normal(shape).astype(np.float32)

        return {"b": f((4,)), "blocks": [{"w": f((3, 4))}, {"w": f((4, 2))}], "head": f((2,))}

    p, g = tree(), tree()
    jp, jm = p, ro.sgd_momentum_init(p)
    tp = jax.tree.map(torch.from_numpy, p)
    tg = jax.tree.map(torch.from_numpy, g)
    tm = sgd_momentum_init(tp)
    assert len(leaves(tm)) == 4 and not any(bool(x.any()) for x in leaves(tm))
    for _ in range(3):
        jp, jm = ro.sgd_momentum_step(jp, jm, g, 0.05, 0.5)
        tp, tm = sgd_momentum_step(tp, tm, tg, 0.05, 0.5)
    for want, got in zip(jax.tree.leaves(jp) + jax.tree.leaves(jm), leaves(tp) + leaves(tm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [997, 8193])
@pytest.mark.parametrize("mode", ["pack", "residual", "want_residual", "both"])
def test_single_client_compress_equals_reference(d, mode):
    """One client's kernel-wire bytes and residual on the plain engine equal
    the reference's ``engine="ref"`` call bit for bit; ``stoch_quant_pack``
    is the wire of the call without a residual."""
    rng = np.random.default_rng(d)
    delta = (0.02 * rng.standard_normal(d)).astype(np.float32)
    res = (0.005 * rng.standard_normal(d)).astype(np.float32)
    b = (np.abs(0.02 * rng.standard_normal(d)) + 0.001).astype(np.float32)
    b[:2] = 0.0  # dead coordinates
    with_res, want_res = mode in ("residual", "both"), mode in ("want_residual", "both")
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    jp, jr = jops.stoch_quant_compress(jkey, delta, b, res if with_res else None, want_residual=want_res,
                                       engine="ref")
    tp, tr = kernels.stoch_quant_compress(prng.fold_in(prng.key(7), 3), torch.from_numpy(delta), torch.from_numpy(b),
                                          torch.from_numpy(res) if with_res else None, want_residual=want_res)
    assert tp.shape == (kernels.padded_len(d) // 8,) and tp.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert (jr is None) == (tr is None)
    if want_res:
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    if mode == "pack":
        want = jops.stoch_quant_pack(jkey, delta, jnp.float32(0.01), engine="ref")
        got = kernels.stoch_quant_pack(prng.fold_in(prng.key(7), 3), torch.from_numpy(delta), torch.tensor(0.01))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_single_client_entry_is_the_batch_entrys_row():
    """Client ``i``'s row of ``stoch_quant_compress_batch`` is
    ``stoch_quant_compress`` with the key ``fold_in(key, i)``."""
    d, m = 997, 3
    deltas = 0.02 * prng.normal(prng.key(1), (m, d))
    packed, res = kernels.stoch_quant_compress_batch(prng.key(2), deltas, torch.tensor(0.02), want_residual=True)
    for i in range(m):
        p, r = kernels.stoch_quant_compress(prng.fold_in(prng.key(2), i), deltas[i], torch.tensor(0.02),
                                            want_residual=True)
        assert torch.equal(p, packed[i]) and torch.equal(r, res[i])


def test_stoch_quant_pack_ref_equals_reference():
    rng = np.random.default_rng(0)
    delta = (0.02 * rng.standard_normal(2048)).astype(np.float32)
    b = np.full(2048, 0.02, np.float32)
    u = rng.random(2048).astype(np.float32)
    want = jref.stoch_quant_pack_ref(delta, b, u)
    got = ref.stoch_quant_pack_ref(*(torch.from_numpy(x) for x in (delta, b, u)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_kernel_entries_keep_their_names_after_a_launch():
    """Calling a kernel's wrapper imports its binding module; the package's
    ``bit_aggregate`` and ``prox_sgd`` stay the ops entries, not those
    modules."""
    packed = torch.zeros((3, 128), dtype=torch.uint8)
    kernels.bit_aggregate(packed, torch.full((1000,), 0.1), 1000, engine="cuda")  # the plain version on the CPU
    w = torch.zeros(2, 16)
    kernels.prox_sgd(w, w[0], w, w, kernels.ops.prox_coeffs(0.1, 0.0, 0.5), engine="cuda")
    assert kernels.bit_aggregate is kernels.ops.bit_aggregate
    assert kernels.prox_sgd is kernels.ops.prox_sgd
