"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

:mod:`.ops` is the public entry (engine dispatch); the kernel bindings
(:mod:`.stoch_quant`, :mod:`.bit_aggregate`, :mod:`.prox_sgd`) build their
CUDA sources at first use, never at import.
"""

from . import ops
from .ops import ENGINES, bit_aggregate, padded_len, prox_sgd, quant_pack_u, resolve_engine, stoch_quant_compress_batch

__all__ = [
    "ops",
    "ENGINES",
    "resolve_engine",
    "padded_len",
    "stoch_quant_compress_batch",
    "quant_pack_u",
    "bit_aggregate",
    "prox_sgd",
]
