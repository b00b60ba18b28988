"""The port stands alone: no module of src/repro_torch and not chip_smoke.py
imports JAX or the JAX package (``repro``)."""

import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s))", re.MULTILINE)


def test_the_port_has_files():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_pattern_catches_what_it_must():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax", "import repro",
                "from repro.core import x", "  from repro import fl", "from jax.experimental import pallas"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import x", "from . import prng",
               "# jax.random.split"):
        assert not FORBIDDEN.search(ok), ok


def test_the_mesh_modules_are_checked():
    """The mesh layer, the model axis's launch modules (the dry run, its
    counting and analysis) and the test ranks' jobs are among the files
    held."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/distributed.py", "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/flopcount.py", "src/repro_torch/launch/analysis.py",
            "src/repro_torch/models/spec.py"} <= names
    hits = FORBIDDEN.findall((ROOT / "tests" / "_torch_ranks.py").read_text())
    assert not hits, f"tests/_torch_ranks.py imports {hits}"


def test_the_theorem_layer_is_checked():
    """The modules of the functional one-bit API, the attack registry, the
    partitioners, the momentum step and the single-client kernel entries
    are among the files held."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/core/quantizer.py", "src/repro_torch/core/aggregation.py",
            "src/repro_torch/core/attacks.py", "src/repro_torch/data/partition.py",
            "src/repro_torch/optim/sgd.py", "src/repro_torch/kernels/ops.py",
            "src/repro_torch/kernels/ref.py", "src/repro_torch/launch/__init__.py"} <= names
