"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

:mod:`.ops` is the public entry (engine dispatch); the kernel bindings
(:mod:`.stoch_quant`, :mod:`.bit_aggregate`, :mod:`.prox_sgd`) build their
CUDA sources at first use, never at import.
"""

# The bindings are imported before the functions of .ops: a submodule
# imported later would rebind the package's ``bit_aggregate`` and
# ``prox_sgd`` to the modules of those names. Importing a binding builds
# nothing.
from . import bit_aggregate as _bit_aggregate_binding, ops, prox_sgd as _prox_sgd_binding  # noqa: F401
from .ops import (
    ENGINES,
    bit_aggregate,
    padded_len,
    prox_sgd,
    quant_pack_u,
    resolve_engine,
    stoch_quant_compress,
    stoch_quant_compress_batch,
    stoch_quant_pack,
)

__all__ = [
    "ops",
    "ENGINES",
    "resolve_engine",
    "padded_len",
    "stoch_quant_pack",
    "stoch_quant_compress",
    "stoch_quant_compress_batch",
    "quant_pack_u",
    "bit_aggregate",
    "prox_sgd",
]
