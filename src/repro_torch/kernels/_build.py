"""Build and load the hand-written CUDA kernels; count their launches.

Each source in ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. That avoids
PyTorch's headers, which take minutes to compile; a source here builds in
seconds. All sources build in parallel, one ``nvcc`` each, at first use, into
:func:`build_dir`: ``$REPRO_TORCH_BUILD_DIR`` when it is set, else
``build/torch_ext/`` at the root of the source checkout the package runs
from. A library is named by the hash of its source and flags, so an
unchanged source is not rebuilt; the compiler's output, with ptxas's
registers and shared memory of every kernel (``-Xptxas -v``), is kept
beside it (:func:`build_log`).

Flags: ``-gencode=arch=compute_90a,code=sm_90a -O3`` and no
``--use_fast_math`` (the kernels must round exactly like their plain
versions). Nothing here runs at import, so the CPU-only tests import every
module without a compiler.

A build or launch error raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["SOURCES", "build_dir", "build_all", "build_log", "library", "check", "launches", "reset_launches"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("stoch_quant", "bit_aggregate", "prox_sgd")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C signatures of the entry points (every one returns its cudaError_t).
_SIGNATURES = {
    "stoch_quant": {
        "probit_stoch_quant_pack": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
        "probit_stoch_quant_ef": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    },
    "bit_aggregate": {
        "probit_bit_aggregate": (_P, _P, _P, _I64, _I64, _I64, _F, _I64, _I64, _I64, _P),
        "probit_bit_aggregate_empty": (_I64, _I64, _P),
    },
    "prox_sgd": {
        "probit_prox_sgd": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P),
        "probit_prox_sgd_occupancy": (_I64, _I64, _P),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
# Kernel launches by kernel name; the wrappers add one per launch.
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build_dir() -> pathlib.Path:
    """Where the libraries are built: ``$REPRO_TORCH_BUILD_DIR`` if set,
    else ``build/torch_ext`` in the checkout that holds ``src/repro_torch``.
    An installed package has no checkout to build in and must be given the
    variable."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env).resolve()
    pkg = pathlib.Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if pkg.parent.name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(
            f"repro_torch at {pkg} is not in a source checkout (<root>/src/repro_torch); "
            "set REPRO_TORCH_BUILD_DIR to the directory to build the CUDA kernels in"
        )
    return root / "build" / "torch_ext"


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu`` (ptxas's resource
    report of each kernel), written when its library was built."""
    return _target(name).with_suffix(".log").read_text()


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source in parallel.
    Returns the wall seconds spent; raises with the compiler's output."""
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if todo:
        nvcc = _nvcc()
        procs = []
        for name, target in todo:
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for name, target, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
            else:
                target.with_suffix(".log").write_text(out)
                os.replace(tmp, target)
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error, else count the launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError_t {rc}")
    launches[kernel] += 1
