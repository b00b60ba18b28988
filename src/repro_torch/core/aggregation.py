"""PRoBit+ aggregation pipeline: client compressor, server, registry.

Counterpart of ``repro/core/aggregation.py`` for the one-bit PRoBit+ wire.
Two halves joined by the packed wire:

* :class:`ClientCompressor` — error feedback -> Eq.-5 binarize -> bit pack,
  emitting a :class:`PackedWire` (``(M, P)`` uint8 rows plus the public
  range ``b``). With ``use_kernels`` it goes through
  :func:`repro_torch.kernels.ops.stoch_quant_compress_batch` (the kernel
  wire, ``padded_len(d)/8`` bytes a row); without, through the chunked
  packer (``padded_dim(d)/8`` bytes a row).
* :class:`ServerAggregator` — the vote-count protocol (init, accumulate,
  finalize); :class:`ProBitPlusServer` finalizes with the Eq.-13 ML
  estimate ``(2 N_i - M)/M * b_i``, through
  :func:`repro_torch.kernels.ops.bit_aggregate` (its plain version,
  ``engine="ref"``, without ``use_kernels``).

Not ported yet: the top-k, k-bit, heterogeneous and dense wires, the
weighted counts, and the signSGD-MV, RSA, FedAvg and Fed-GM servers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .privacy import DPConfig
from .quantizer import PACK_CHUNK, packed_binarize_batch, packed_counts, padded_dim, wire_bytes

__all__ = [
    "ml_estimate_from_counts",
    "PackedWire",
    "ClientCompressor",
    "ServerAggregator",
    "ProBitPlusServer",
    "AggregatorPipeline",
    "build_pipeline",
    "available_aggregators",
]


def ml_estimate_from_counts(counts: torch.Tensor, m: int, b: torch.Tensor) -> torch.Tensor:
    """Eq. 13: ``theta_hat_i = (2 N_i - M)/M * b_i`` in f32.

    The division is a multiply by the f32 reciprocal of M: that is what the
    reference computes under ``jit`` (XLA folds the division by the
    constant M), and the kernel does the same, so all three agree bit for
    bit.
    """
    recip = float(np.float32(1.0) / np.float32(m))
    return (2.0 * counts.float() - m) * recip * b


@dataclasses.dataclass(frozen=True)
class PackedWire:
    """Canonical wire: (M, P) uint8 packed codes (P * 8 >= d) + range b (d,)."""

    packed: torch.Tensor
    b: torch.Tensor
    d: int

    @property
    def n_clients(self) -> int:
        return self.packed.shape[0]

    @property
    def wire_bytes(self) -> int:
        return self.packed.shape[0] * self.packed.shape[1]


@dataclasses.dataclass(frozen=True)
class ClientCompressor:
    """Client half: error feedback -> Eq.-5 binarize -> bit pack.

    ``engine`` is passed to :mod:`repro_torch.kernels.ops` (None: resolve
    from the tensors' device).
    """

    error_feedback: bool = False
    dp: DPConfig = DPConfig(0.0)
    use_kernels: bool = False
    chunk: int = PACK_CHUNK
    engine: str | None = None

    def wire_bytes(self, d: int) -> int:
        """Bytes per packed wire row for dimension ``d``."""
        if self.use_kernels:
            from ..kernels.ops import padded_len

            return wire_bytes(d, d_pad=padded_len(d))
        return wire_bytes(d, d_pad=padded_dim(d, self.chunk))

    def b_vector(self, d: int, b_scalar: torch.Tensor) -> torch.Tensor:
        """The public (d,) range: the controller's b plus the Theorem-3
        margin when DP is on."""
        b_eff = b_scalar + self.dp.b_margin if self.dp.enabled else b_scalar
        return torch.broadcast_to(b_eff.float(), (d,)).contiguous()

    def compress(
        self,
        key: torch.Tensor,
        deltas: torch.Tensor,
        b_scalar: torch.Tensor,
        residuals: torch.Tensor,
        *,
        row_offset: int = 0,
    ) -> tuple[PackedWire, torch.Tensor]:
        """(M, d) updates -> (wire, residuals'). Residuals pass through
        unchanged unless error feedback is on (never under DP)."""
        m, d = deltas.shape
        use_ef = self.error_feedback and not self.dp.enabled
        b_vec = self.b_vector(d, b_scalar)
        if self.use_kernels:
            from ..kernels import ops as kops

            packed, res = kops.stoch_quant_compress_batch(
                key, deltas, b_vec, residual=residuals if use_ef else None,
                row_offset=row_offset, chunk=self.chunk, want_residual=use_ef,
                engine=self.engine,
            )
        else:
            eff = deltas + residuals if use_ef else deltas
            packed, res = packed_binarize_batch(
                key, eff, b_vec, chunk=self.chunk, want_residual=use_ef, row_offset=row_offset
            )
        return PackedWire(packed=packed, b=b_vec, d=d), (res if use_ef else residuals)


@dataclasses.dataclass(frozen=True)
class ServerAggregator:
    """Server half: vote-count accumulation -> estimate.

    :meth:`init_counts` makes a zero int32 carry for a ``P``-byte row,
    :meth:`accumulate_counts` folds any client chunk into it (counts are
    additive over clients), :meth:`finalize` applies the scheme's estimate.
    A scheme's :meth:`aggregate` estimates from a whole wire in one shot.
    """

    def from_counts(self, counts: torch.Tensor, m: int, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def init_counts(self, p_bytes: int, device=None) -> torch.Tensor:
        """Zero vote counts in int32: a uint8 count wraps past 255 clients."""
        return torch.zeros((8 * p_bytes,), dtype=torch.int32, device=device)

    def accumulate_counts(self, counts: torch.Tensor, wire_chunk: torch.Tensor) -> torch.Tensor:
        return counts + packed_counts(wire_chunk)

    def finalize(self, counts: torch.Tensor, m: int, b: torch.Tensor) -> torch.Tensor:
        """The estimate from accumulated counts (pad bits sliced off)."""
        return self.from_counts(counts[: b.shape[0]], m, b)

    def aggregate(self, wire: PackedWire) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ProBitPlusServer(ServerAggregator):
    """Eq.-13 ML estimate through ``ops.bit_aggregate``: the fused count
    kernel with ``use_kernels``, else its plain version."""

    use_kernels: bool = False
    engine: str | None = None

    def from_counts(self, counts, m, b):
        return ml_estimate_from_counts(counts, m, b)

    def aggregate(self, wire: PackedWire) -> torch.Tensor:
        from ..kernels import ops as kops

        # The kernel wire is padded_len(d)/8 bytes; a wire from the chunked
        # packer may carry more or fewer pad bytes. Pad bits encode
        # coordinates >= d, which bit_aggregate slices off, so realigning
        # is lossless.
        packed = kops.realign_wire(wire.packed, kops.padded_len(wire.d) // 8)
        engine = self.engine if self.use_kernels else "ref"
        return kops.bit_aggregate(packed, wire.b, wire.d, engine=engine)


@dataclasses.dataclass(frozen=True)
class AggregatorPipeline:
    """One named aggregation scheme: compressor + server."""

    name: str
    compressor: ClientCompressor
    server: ServerAggregator

    def compress_wire(
        self,
        key: torch.Tensor,
        deltas: torch.Tensor,
        b_scalar: torch.Tensor,
        residuals: torch.Tensor,
        *,
        flip_n: int = 0,
    ) -> tuple[PackedWire, torch.Tensor]:
        """Client half: compress every client onto the wire. ``flip_n > 0``
        arms the ``bit_flip`` adversary, which inverts the first ``flip_n``
        rows after compression (their residuals stay the honest ones)."""
        wire, residuals = self.compressor.compress(key, deltas, b_scalar, residuals)
        if flip_n:
            from .attacks import flip_wire

            wire = flip_wire(wire, flip_n)
        return wire, residuals

    def estimate(self, wire: PackedWire) -> torch.Tensor:
        """Server half: theta_hat (d,) from the wire."""
        return self.server.aggregate(wire)


_AGGREGATORS = ("probit_plus", "fedavg", "fed_gm", "signsgd_mv", "rsa")


def available_aggregators() -> tuple[str, ...]:
    """Every aggregator the reference knows; only probit_plus is ported."""
    return tuple(sorted(_AGGREGATORS))


def build_pipeline(
    name: str,
    *,
    dp: DPConfig = DPConfig(0.0),
    error_feedback: bool = False,
    use_kernels: bool = False,
    chunk: int = PACK_CHUNK,
    engine: str | None = None,
) -> AggregatorPipeline:
    """Resolve an aggregator name into a configured pipeline."""
    if name not in _AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r}; available: {available_aggregators()}")
    if name != "probit_plus":
        raise NotImplementedError(
            f"aggregator {name!r} is not ported yet (ROADMAP A4: the other servers)"
        )
    return AggregatorPipeline(
        name=name,
        compressor=ClientCompressor(
            error_feedback=error_feedback, dp=dp,
            use_kernels=use_kernels, chunk=chunk, engine=engine,
        ),
        server=ProBitPlusServer(use_kernels=use_kernels, engine=engine),
    )
