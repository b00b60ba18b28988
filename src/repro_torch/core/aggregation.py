"""Aggregation pipelines: client compressor, server, registry.

Counterpart of ``repro/core/aggregation.py`` for the one-bit and dense
wires. Two halves joined by a wire:

* :class:`ClientCompressor` — ``mode="pack_stochastic"`` (PRoBit+):
  error feedback -> Eq.-5 binarize -> bit pack, emitting a
  :class:`PackedWire` (``(M, P)`` uint8 rows plus the public range ``b``,
  the controller's scalar or, with ``b_mode="oracle"``, the per-coordinate
  :func:`~repro_torch.core.bcontrol.oracle_b`). With ``use_kernels`` it goes
  through :func:`repro_torch.kernels.ops.stoch_quant_compress_batch` (the
  kernel wire, ``padded_len(d)/8`` bytes a row); without, through the
  chunked packer (``padded_dim(d)/8`` bytes a row). ``mode="pack_sign"``
  (signSGD-MV, RSA) packs ``delta >= 0`` on the chunked wire;
  ``mode="dense"`` (FedAvg, Fed-GM) passes the updates through as a
  :class:`DenseWire`.
* :class:`ServerAggregator` — the vote-count protocol (init, accumulate,
  finalize) for packed wires, ``from_dense`` for dense ones.
  :class:`ProBitPlusServer` finalizes with the Eq.-13 ML estimate
  ``(2 N_i - M)/M * b_i`` through :func:`repro_torch.kernels.ops.bit_aggregate`
  (its plain version, ``engine="ref"``, without ``use_kernels``);
  :class:`SignSGDMVServer` and :class:`RSAServer` count with
  :func:`~repro_torch.core.quantizer.packed_counts`, as the reference does.

Weights, one per wire row (the buffered-asynchronous server's staleness
weights, or the 0/1 weights of a streaming round's pad rows), select the
weighted path: the counts become ``N_i^w = sum_m w_m 1[c_i^m = +1]``
(:func:`~repro_torch.core.quantizer.packed_weighted_counts`, plain torch:
the count kernel has no weighted form, as in the reference) and M becomes
``M^w = sum_m w_m``. The streaming round folds chunks of clients into the
same carries (``stream_kind``: vote counts, FedAvg's weighted running sum,
or Fed-GM's buffer of every row).

A campaign group of E runs compresses and estimates in one call: keys
``(E, 2)``, updates ``(E, M, d)``, b ``(E,)``, and wires with a leading E
(:attr:`PackedWire.elements`). PRoBit+ counts an unweighted group with one
launch of the count kernel; every other estimate of a group is its
elements' own, one after another.

Every mean is a sum times the f32 reciprocal of the count
(:func:`mean_rows`): the reference computes its means so under ``jit``
(XLA folds a division by a constant), and on the card torch divides by a
Python number the same way, so the CPU and the card agree. The weighted
estimate multiplies by the f32 reciprocal of ``M^w`` too, so unit weights
give the unweighted estimate bit for bit; the jitted reference divides by
its traced ``M^w`` (XLA keeps a division by a traced value), which can
differ in the last bit.

The k-bit wire (``wire_bits`` in {2, 4}, :class:`PackedWire` with
``bits``) travels as ``bits`` one-bit planes, so its vote counts are the
per-plane counts and PRoBit+ finalizes them with the L-level estimate
:func:`kbit_estimate_from_counts`; under DP it carries L-level randomized
response (``privacy.rr_gamma``) instead of the Theorem-3 margin, which
applies at one bit only. Per-client widths (``client_bits``) make a
:class:`HeteroWire` of contiguous equal-width groups, estimated group by
group and merged with inverse-variance weights ``M_g (2**k_g - 1)**2``. The
top-k wire (``topk_frac < 1``) is a :class:`SparseWire` of indices and
packed codes (:mod:`repro_torch.core.sparse`); with ``use_kernels`` its
gathered values are packed by the pack kernel (``ops.quant_pack_u``). The
reference has no kernel for the k-bit and mixed-width wires, the sparse
estimate or the L-level estimate: they are plain torch here as they are
plain JAX there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import prng
from .privacy import DPConfig, rr_gamma
from .quantizer import (
    PACK_CHUNK,
    WIRE_BITS,
    _grid_step,
    _unpack_lastdim,
    codes_to_counts,
    pack_levels,
    packed_binarize_batch,
    packed_counts,
    packed_quantize_batch,
    packed_sign_batch,
    packed_weighted_counts,
    padded_dim,
    stochastic_binarize,
    uniform_block_rows,
    wire_bytes,
)

__all__ = [
    "recip32",
    "mean_rows",
    "ml_estimate_from_counts",
    "kbit_estimate_from_counts",
    "hetero_client_groups",
    "staleness_weights",
    "probit_plus_aggregate",
    "probit_plus_from_updates",
    "fedavg_aggregate",
    "geometric_median",
    "signsgd_mv_aggregate",
    "rsa_aggregate",
    "PackedWire",
    "HeteroWire",
    "SparseWire",
    "DenseWire",
    "ClientCompressor",
    "ServerAggregator",
    "ProBitPlusServer",
    "SignSGDMVServer",
    "RSAServer",
    "FedAvgServer",
    "FedGMServer",
    "AggregatorPipeline",
    "build_pipeline",
    "available_aggregators",
]


def recip32(n: float) -> float:
    """``f32(1 / f32(n))`` as a Python float: what XLA multiplies by where
    the reference divides by the constant ``n`` under ``jit``."""
    return float(np.float32(1.0) / np.float32(n))


def mean_rows(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading axis as ``sum * f32(1/n)``."""
    return x.sum(0) * recip32(x.shape[0])


def ml_estimate_from_counts(counts: torch.Tensor, m, b: torch.Tensor) -> torch.Tensor:
    """Eq. 13: ``theta_hat_i = (2 N_i - M)/M * b_i`` in f32.

    The division is a multiply by the f32 reciprocal of M: that is what the
    reference computes under ``jit``, and the kernel does the same, so all
    three agree bit for bit. ``m`` may be a 0-dim f32 tensor (the weighted
    ``M^w``); its reciprocal is then the device's correctly rounded f32
    ``1 / m``, which for ``m = f32(M)`` is ``recip32(M)``.
    """
    return (2.0 * counts.float() - m) * _recip(m) * b


def _recip(m):
    """The multiplier of a division by the cohort size ``m``: ``f32(1/m)``
    for a number (what XLA folds the reference's division by a constant
    into), the device's correctly rounded f32 reciprocal for a 0-dim tensor
    (the weighted ``M^w``, for which ``f32(M)`` gives ``recip32(M)``)."""
    return recip32(m) if isinstance(m, (int, np.integer)) else torch.reciprocal(m)


def kbit_estimate_from_counts(counts: torch.Tensor, m, b: torch.Tensor, bits: int,
                              gamma: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 13 for the L-level grid, from the ``(bits, d)`` plane counts:
    ``theta_i = -b_i + step_i * mean_level_i`` with ``mean_level = sum_p 2^p
    N_p / M`` and ``step = 2b/(L-1)``, debiased by ``1/(1 - gamma)`` for the
    randomized-response wire and clipped to ``[-b, b]``.

    As the reference computes it under ``jit``: the division by M is a
    multiply by its reciprocal (:func:`ml_estimate_from_counts`' rule, so
    unit weights give the unweighted estimate bit for bit), ``-b + step *
    mean`` one fused multiply-add, the gamma rescale a true division.
    """
    weights = (2.0 ** torch.arange(bits, dtype=torch.float32, device=counts.device)).unsqueeze(-1)
    mean_level = (weights * counts.float()).sum(0) * _recip(m)
    b = torch.broadcast_to(b, mean_level.shape).float()
    theta = prng._fma(_grid_step(b, bits), mean_level, -b)
    if gamma is not None:
        theta = theta / torch.clamp(1.0 - gamma, min=1e-6)
    return torch.clamp(theta, -b, b)


def hetero_client_groups(client_bits) -> tuple[tuple[int, int, int], ...]:
    """Run-length encode per-client widths into contiguous ``(start, stop,
    bits)`` groups, the groups a mixed-width cohort compresses one by one
    and the server merges; raises on a width not in ``WIRE_BITS``."""
    bits_list = tuple(int(k) for k in client_bits)
    for k in bits_list:
        if k not in WIRE_BITS:
            raise ValueError(f"per-client bit-widths must be in {WIRE_BITS}, got {k}")
    groups, start = [], 0
    for i in range(1, len(bits_list) + 1):
        if i == len(bits_list) or bits_list[i] != bits_list[start]:
            groups.append((start, i, bits_list[start]))
            start = i
    return tuple(groups)


def staleness_weights(ages: torch.Tensor, decay: float, valid: torch.Tensor | None = None) -> torch.Tensor:
    """The asynchronous server's staleness discount ``(1 + age) ** -decay``
    in f32, zero where ``valid`` is False. All ones at ``decay = 0``, which
    makes the zero-latency asynchronous round the synchronous one. torch's
    f32 ``pow`` may differ from XLA's in the last bit at a fractional
    ``decay``."""
    w = (1.0 + ages.float()) ** (-decay)
    if valid is not None:
        w = torch.where(valid, w, torch.zeros_like(w))
    return w


def probit_plus_aggregate(codes: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Eq. 13 from the one-bit codes of M clients: ``(M, d)`` int8 codes ->
    theta_hat ``(d,)``, the ML estimate of their vote counts over the
    leading (client) axis. Draws batched behind the client axis come out
    batched: ``(M, R, d)`` codes give ``(R, d)``."""
    return ml_estimate_from_counts(codes_to_counts(codes), codes.shape[0], b)


def probit_plus_from_updates(key: torch.Tensor, updates: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The functional PRoBit+ round: client ``m`` binarizes its row of the
    ``(M, d)`` updates with key ``split(key, M)[m]``
    (:func:`~repro_torch.core.quantizer.stochastic_binarize`), then
    :func:`probit_plus_aggregate`.

    Keys ``(..., 2)`` give one estimate a key, ``(..., d)``, as
    ``jax.vmap`` of the reference over them: every client of every key is
    drawn in one pass, a block of keys at a time whose codes stay near
    ``UNIFORM_BLOCK_WORDS`` bytes, so only the estimates outlive a block.
    """
    m = updates.shape[0]
    keys = key.reshape(-1, 2)
    out = torch.empty((keys.shape[0],) + updates.shape[1:], dtype=torch.float32, device=updates.device)
    step = uniform_block_rows(updates.numel())
    for r0 in range(0, keys.shape[0], step):
        client_keys = prng.split(keys[r0:r0 + step], m).movedim(-2, 0)  # (M, block, 2)
        out[r0:r0 + step] = probit_plus_aggregate(stochastic_binarize(client_keys, updates.unsqueeze(1), b), b)
    return out.reshape(key.shape[:-1] + updates.shape[1:])


def fedavg_aggregate(updates: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """FedAvg: the mean of the (M, d) client updates, or their weighted mean.

    The weighted mean is ``mean(u * (w * (M / sum(w))))``, the reference's
    form: with unit weights the rescale is exactly 1 and the result is the
    unweighted mean bit for bit. No weight at all gives zero.
    """
    if weights is None:
        return mean_rows(updates)
    wsum = weights.float().sum()
    scale = torch.full_like(wsum, updates.shape[0]) / wsum.clamp(min=1e-12)
    mean = mean_rows(updates * (weights * scale)[:, None])
    return torch.where(wsum > 0, mean, torch.zeros_like(mean))


def geometric_median(
    updates: torch.Tensor, iters: int = 16, eps: float = 1e-8, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Fed-GM (Yin et al. 2018): ``iters`` smoothed Weiszfeld steps from the
    (weighted) mean, each weighting row ``m`` by ``w_m / sqrt(||u_m - y||^2
    + eps)`` (``w_m = 1`` without weights), so rows of weight zero drop out."""
    y = fedavg_aggregate(updates, weights)
    for _ in range(iters):
        dist = torch.sqrt(((updates - y) ** 2).sum(-1) + eps)
        w = 1.0 / dist if weights is None else weights / dist
        y = (updates * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1e-12)
    return y


def signsgd_mv_aggregate(codes: torch.Tensor, step: float = 0.01) -> torch.Tensor:
    """signSGD with majority vote (Bernstein et al. 2019) from ``(M, d)``
    codes: ``step`` times the sign of their f32 sum over the clients (0 at
    a tie, as ``jnp.sign``)."""
    return step * torch.sign(codes.float().sum(0))


def rsa_aggregate(codes: torch.Tensor, step: float = 0.01) -> torch.Tensor:
    """RSA's server step (Li et al. 2019) from ``(M, d)`` codes: ``step``
    times the f32 sum of the client signs."""
    return step * codes.float().sum(0)


@dataclasses.dataclass(frozen=True)
class PackedWire:
    """Canonical wire: (M, bits * P) uint8 packed codes (P * 8 >= d; ``bits``
    planes, plane-major) + range b (d,); a group's wire has a leading E on
    both."""

    packed: torch.Tensor
    b: torch.Tensor
    d: int
    bits: int = 1

    @property
    def n_clients(self) -> int:
        return self.packed.shape[-2]

    @property
    def wire_bytes(self) -> int:
        return self.packed.numel()

    @property
    def elements(self) -> int | None:
        """E of a group's wire, None for one run's."""
        return self.packed.shape[0] if self.packed.dim() == 3 else None

    def element(self, e: int) -> "PackedWire":
        return PackedWire(packed=self.packed[e], b=self.b[e], d=self.d, bits=self.bits)


@dataclasses.dataclass(frozen=True)
class HeteroWire:
    """Per-client widths: one :class:`PackedWire` per contiguous group of
    equal width (:func:`hetero_client_groups`), in cohort order."""

    wires: tuple

    @property
    def n_clients(self) -> int:
        return sum(w.n_clients for w in self.wires)

    @property
    def d(self) -> int:
        return self.wires[0].d

    @property
    def wire_bytes(self) -> int:
        return sum(w.wire_bytes for w in self.wires)

    @property
    def elements(self) -> int | None:
        return self.wires[0].elements

    def element(self, e: int) -> "HeteroWire":
        return HeteroWire(wires=tuple(w.element(e) for w in self.wires))


@dataclasses.dataclass(frozen=True)
class SparseWire:
    """Top-k wire: indices (M, k) int32 + packed codes (M, ceil(k/8)) +
    range b (d,)."""

    indices: torch.Tensor
    packed: torch.Tensor
    b: torch.Tensor
    d: int
    k: int

    @property
    def elements(self) -> int | None:
        return self.indices.shape[0] if self.indices.dim() == 3 else None

    def element(self, e: int) -> "SparseWire":
        return SparseWire(indices=self.indices[e], packed=self.packed[e], b=self.b[e], d=self.d, k=self.k)


def _unpack_codes(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(M, P) packed rows -> (M, n) int8 codes in {-1, +1}."""
    return _unpack_lastdim(packed)[..., :n].to(torch.int8) * 2 - 1


@dataclasses.dataclass(frozen=True)
class DenseWire:
    """Full-precision passthrough (FedAvg / Fed-GM)."""

    updates: torch.Tensor  # (M, d) f32; (E, M, d) for a group

    @property
    def elements(self) -> int | None:
        return self.updates.shape[0] if self.updates.dim() == 3 else None

    def element(self, e: int) -> "DenseWire":
        return DenseWire(updates=self.updates[e])


@dataclasses.dataclass(frozen=True)
class ClientCompressor:
    """Client half: ``mode`` is ``"pack_stochastic"`` (PRoBit+: error
    feedback -> top-k -> Eq.-5 binarize or k-bit quantize -> bit pack),
    ``"pack_sign"`` (sign codes) or ``"dense"`` (identity).

    ``rand_bits=16`` draws 16-bit words for the one-bit wire (the LM
    trainer's option; not on the kernel or top-k wires).
    ``wire_bits`` is the width of every client's values (1, 2 or 4) and
    ``client_bits`` one width a cohort row (a :class:`HeteroWire`; it
    overrides ``wire_bits``); ``topk_frac < 1`` uploads the top-k
    coordinates only (a :class:`SparseWire`). ``engine`` is passed to
    :mod:`repro_torch.kernels.ops` (None: resolve from the tensors' device).
    """

    mode: str = "pack_stochastic"
    error_feedback: bool = False
    topk_frac: float = 1.0
    dp: DPConfig = DPConfig(0.0)
    b_mode: str = "dynamic"
    use_kernels: bool = False
    chunk: int = PACK_CHUNK
    engine: str | None = None
    # Quantizer draw width: 32 = f32 uniforms, 16 = 16-bit draws against a
    # wider threshold (quantizer.threshold_u16). The kernel and top-k wires
    # take 32 only, as in the reference.
    rand_bits: int = 32
    wire_bits: int = 1
    client_bits: tuple | None = None

    def __post_init__(self):
        if self.rand_bits not in (16, 32):
            raise ValueError(f"rand_bits must be 16 or 32, got {self.rand_bits}")
        if self.rand_bits == 16 and self.use_kernels:
            raise ValueError("rand_bits=16 is not supported on the kernel wire")
        if self.rand_bits == 16 and self.topk_frac < 1.0:
            raise ValueError("rand_bits=16 is not supported on the top-k wire")
        if self.wire_bits not in WIRE_BITS:
            raise ValueError(f"wire_bits must be one of {WIRE_BITS}, got {self.wire_bits}")
        if self.wire_bits > 1:
            if self.mode != "pack_stochastic":
                raise ValueError(f"wire_bits > 1 requires the pack_stochastic wire (got mode={self.mode!r})")
            if self.topk_frac < 1.0:
                raise ValueError("wire_bits > 1 is not supported on the top-k wire")
            if self.rand_bits != 32:
                raise ValueError("wire_bits > 1 requires rand_bits=32")
        if self.client_bits is not None:
            object.__setattr__(self, "client_bits", tuple(int(k) for k in self.client_bits))
            hetero_client_groups(self.client_bits)  # validates each entry
            if self.mode != "pack_stochastic":
                raise ValueError("per-client bit-widths require the pack_stochastic wire")
            if self.use_kernels:
                raise ValueError(
                    "per-client bit-widths are not supported on the kernel wire (compress per-group without "
                    "use_kernels)"
                )
            if self.topk_frac < 1.0:
                raise ValueError("per-client bit-widths are not supported on the top-k wire")

    def wire_bytes(self, d: int) -> int | None:
        """Bytes per packed wire row for dimension ``d`` (None for dense)."""
        if self.mode == "dense":
            return None
        if self.use_kernels and self.mode == "pack_stochastic":
            from ..kernels.ops import padded_len

            return wire_bytes(d, self.wire_bits, d_pad=padded_len(d))
        return wire_bytes(d, self.wire_bits, d_pad=padded_dim(d, self.chunk))

    @property
    def _range_dp(self) -> DPConfig:
        """The DP config the range ``b`` answers to: the Theorem-3 margin
        protects the one-bit wire; the k-bit wire earns its guarantee from
        randomized response and keeps the honest range."""
        return self.dp if self.wire_bits == 1 else DPConfig(0.0)

    def b_vector(self, d: int, b_scalar: torch.Tensor) -> torch.Tensor:
        """The public (d,) range of the packed wires outside oracle mode:
        ones for sign codes, else the controller's b plus the Theorem-3
        margin when DP is on at one bit. The streaming round finalizes its
        counts with it; oracle b maxes over the whole cohort and cannot
        stream."""
        if self.b_mode == "oracle":
            raise ValueError("oracle b depends on all updates and cannot stream")
        if self.mode == "pack_sign":
            return torch.ones(b_scalar.shape + (d,), device=b_scalar.device)
        dp = self._range_dp
        b_eff = b_scalar + dp.b_margin if dp.enabled else b_scalar
        return torch.broadcast_to(b_eff.float().unsqueeze(-1), b_eff.shape + (d,)).contiguous()

    def _gamma(self, b_vec: torch.Tensor) -> torch.Tensor | None:
        """Randomized-response weight of the k-bit DP wire (None otherwise)."""
        if self.wire_bits > 1 and self.dp.enabled:
            return rr_gamma(self.dp.epsilon, self.dp.l1_sensitivity, b_vec, self.wire_bits)
        return None

    def compress(
        self,
        key: torch.Tensor,
        deltas: torch.Tensor,
        b_scalar: torch.Tensor,
        residuals: torch.Tensor,
        *,
        row_offset: int = 0,
    ):
        """(M, d) updates -> (wire, residuals'). Residuals pass through
        unchanged unless PRoBit+'s error feedback is on (never under DP).
        A group (one-bit dense wires only): keys (E, 2), updates and
        residuals (E, M, d), b (E,)."""
        d = deltas.shape[-1]
        if self.mode == "dense":
            return DenseWire(updates=deltas), residuals
        if self.mode == "pack_sign":
            packed = packed_sign_batch(deltas, chunk=self.chunk)
            ones = torch.ones(deltas.shape[:-2] + (d,), device=deltas.device)
            return PackedWire(packed=packed, b=ones, d=d), residuals
        if self.client_bits is not None:
            return self._compress_hetero(key, deltas, b_scalar, residuals, row_offset)
        use_ef = self.error_feedback and not self.dp.enabled
        if self.b_mode == "oracle":
            from .bcontrol import oracle_b

            # the oracle ranges the error-feedback sum that is quantized
            b_vec = oracle_b(deltas + residuals if use_ef else deltas, self._range_dp)
        else:
            b_vec = self.b_vector(d, b_scalar)
        if self.topk_frac < 1.0:
            return self._compress_topk(key, deltas + residuals if use_ef else deltas, b_vec, residuals, use_ef)
        if self.wire_bits > 1:
            eff = deltas + residuals if use_ef else deltas
            gamma = self._gamma(b_vec)
            if self.use_kernels:
                from ..kernels import ops as kops

                packed, res = kops.stoch_quant_compress_batch(
                    key, eff, b_vec, row_offset=row_offset, chunk=self.chunk, want_residual=use_ef,
                    engine=self.engine, bits=self.wire_bits, gamma=gamma,
                )
            else:
                packed, res = packed_quantize_batch(key, eff, b_vec, bits=self.wire_bits, chunk=self.chunk,
                                                    want_residual=use_ef, row_offset=row_offset, gamma=gamma)
            wire = PackedWire(packed=packed, b=b_vec, d=d, bits=self.wire_bits)
            return wire, (res if use_ef else residuals)
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
                key, eff, b_vec, chunk=self.chunk, want_residual=use_ef, row_offset=row_offset,
                rand_bits=self.rand_bits,
            )
        return PackedWire(packed=packed, b=b_vec, d=d), (res if use_ef else residuals)

    def _compress_hetero(self, key, deltas, b_scalar, residuals, row_offset):
        """Each contiguous group of equal width through a homogeneous
        compressor, its rows keyed by their cohort positions."""
        if len(self.client_bits) != deltas.shape[0]:
            raise ValueError(
                f"client_bits has {len(self.client_bits)} entries for a {deltas.shape[0]}-client cohort"
            )
        wires, res_parts = [], []
        for start, stop, gbits in hetero_client_groups(self.client_bits):
            sub = dataclasses.replace(self, client_bits=None, wire_bits=gbits)
            w, r = sub.compress(key, deltas[start:stop], b_scalar, residuals[start:stop], row_offset=row_offset + start)
            wires.append(w)
            res_parts.append(r)
        return HeteroWire(wires=tuple(wires)), torch.cat(res_parts, dim=0)

    def _compress_topk(self, key, eff, b_vec, residuals, use_ef):
        """The top-k wire: client ``m`` (key ``split(key, M)[m]``) sends the
        Eq.-5 bits of its ``k`` largest ``|eff|`` and their indices; with
        ``use_kernels`` the gathered values are packed by the pack kernel
        (one launch for the cohort). Under error feedback the unreported
        coordinates carry their whole value forward."""
        from .sparse import topk_binarize, topk_indices

        m, d = eff.shape
        k = max(int(d * self.topk_frac), 1)
        keys = prng.split(key, m)
        if self.use_kernels:
            from ..kernels import ops as kops

            idx = topk_indices(eff, k)
            packed = kops.quant_pack_u(eff.gather(1, idx), b_vec[idx], prng.uniform(keys, (k,)),
                                       engine=self.engine)[:, : (k + 7) // 8].contiguous()
            idx, codes = idx.to(torch.int32), None
        else:
            idx, codes = topk_binarize(keys, eff, b_vec, k)
            packed = pack_levels((codes > 0).to(torch.uint8), 1)
        if use_ef:
            if codes is None:
                codes = _unpack_codes(packed, k)
            sent = torch.zeros_like(eff)
            sent[torch.arange(m, device=eff.device)[:, None], idx.long()] = codes.float()
            # unreported coordinates carry their full delta forward
            residuals = eff - sent * b_vec
        return SparseWire(indices=idx, packed=packed, b=b_vec, d=d, k=k), residuals


@dataclasses.dataclass(frozen=True)
class ServerAggregator:
    """Server half: vote-count accumulation -> estimate.

    :meth:`init_counts` makes a zero count carry for a ``P``-byte row (int32,
    or f32 when weighted), :meth:`accumulate_counts` folds any client chunk
    into it (counts are additive over clients), :meth:`finalize` applies the
    scheme's estimate, :meth:`finalize_weighted` to weighted counts.
    :meth:`aggregate` estimates from a whole wire in one shot: a dense wire
    through :meth:`from_dense`, a packed one through its vote counts,
    weighted when ``weights`` is given. ``stream_kind`` names
    the carry a streaming round folds chunks into: ``"counts"``, FedAvg's
    ``"sum"`` (:meth:`init_stream_sum`, :meth:`accumulate_sum`,
    :meth:`finalize_sum`) or Fed-GM's ``"buffer"`` of every row.
    """

    stream_kind = "counts"

    def from_counts(self, counts: torch.Tensor, m, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def from_dense(self, updates: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
        raise NotImplementedError

    def init_counts(self, p_bytes: int, device=None, *, weighted: bool = False) -> torch.Tensor:
        """Zero vote counts: int32 (a uint8 count wraps past 255 clients), or
        f32 when weights fold in (exact for 0/1 weights below 2**24 clients)."""
        return torch.zeros((8 * p_bytes,), dtype=torch.float32 if weighted else torch.int32, device=device)

    def accumulate_counts(
        self, counts: torch.Tensor, wire_chunk: torch.Tensor, weights_chunk: torch.Tensor | None = None
    ) -> torch.Tensor:
        if weights_chunk is None:
            return counts + packed_counts(wire_chunk)
        return counts + packed_weighted_counts(wire_chunk, weights_chunk)

    def finalize(self, counts: torch.Tensor, m, b: torch.Tensor) -> torch.Tensor:
        """The estimate from accumulated counts (pad bits sliced off); ``m``
        is the cohort size, or the 0-dim f32 weight sum ``M^w``."""
        return self.from_counts(counts[: b.shape[0]], m, b)

    def finalize_weighted(self, counts: torch.Tensor, wsum: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The estimate from weighted counts and their 0-dim f32 weight sum
        ``M^w``; an empty buffer (nothing has arrived yet) estimates zero."""
        est = self.finalize(counts, wsum.clamp(min=1e-12), b)
        return torch.where(wsum > 0, est, torch.zeros_like(est))

    def init_stream_sum(self, d: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero ``(sum_m w_m u_m, sum_m w_m)`` carry of a dense streaming round."""
        return torch.zeros(d, device=device), torch.zeros((), device=device)

    def accumulate_sum(self, carry, updates: torch.Tensor, weights_chunk: torch.Tensor):
        s, w = carry
        return s + (updates * weights_chunk[:, None]).sum(0), w + weights_chunk.sum()

    def finalize_sum(self, carry) -> torch.Tensor:
        """The weighted mean ``s / w`` (a true division by the traced sum, as
        in the reference); zero when no weight arrived."""
        s, w = carry
        return torch.where(w > 0, s / w.clamp(min=1e-12), torch.zeros_like(s))

    def aggregate(self, wire, weights: torch.Tensor | None = None) -> torch.Tensor:
        """theta_hat (d,) from a wire; (E, d) from a group's wire (and (E, M)
        weights), each element estimated on its own."""
        if wire.elements is not None:
            return torch.stack([self.aggregate(wire.element(e), None if weights is None else weights[e])
                                for e in range(wire.elements)])
        if isinstance(wire, DenseWire):
            return self.from_dense(wire.updates, weights)
        if isinstance(wire, SparseWire):
            raise TypeError(f"{type(self).__name__} cannot consume SparseWire")
        if weights is None:
            return self.finalize(packed_counts(wire.packed), wire.n_clients, wire.b)
        return self.finalize_weighted(packed_weighted_counts(wire.packed, weights), weights.float().sum(), wire.b)


@dataclasses.dataclass(frozen=True)
class ProBitPlusServer(ServerAggregator):
    """Eq.-13 ML estimate through ``ops.bit_aggregate``: the fused count
    kernel with ``use_kernels``, else its plain version; a group's
    unweighted wire in one call.

    ``wire_bits > 1`` finalizes the plane counts with the L-level estimate
    :func:`kbit_estimate_from_counts` (the reference has no kernel for it);
    ``dp`` mirrors the compressor's, so the server can debias the
    randomized-response mix. A wire's own ``bits`` decides how it is
    estimated. A :class:`HeteroWire` is estimated group by group and merged
    with inverse-variance weights, a :class:`SparseWire` by
    :func:`~repro_torch.core.sparse.sparse_aggregate`.
    """

    use_kernels: bool = False
    engine: str | None = None
    wire_bits: int = 1
    dp: DPConfig = DPConfig(0.0)

    def from_counts(self, counts, m, b):
        return ml_estimate_from_counts(counts, m, b)

    def finalize(self, counts, m, b):
        if self.wire_bits == 1:
            return super().finalize(counts, m, b)
        plane_counts = counts.reshape(self.wire_bits, -1)[:, : b.shape[-1]]
        gamma = None
        if self.dp.enabled:
            gamma = rr_gamma(self.dp.epsilon, self.dp.l1_sensitivity, b, self.wire_bits)
        return kbit_estimate_from_counts(plane_counts, m, b, self.wire_bits, gamma)

    def aggregate(self, wire, weights: torch.Tensor | None = None) -> torch.Tensor:
        from ..kernels import ops as kops

        if isinstance(wire, PackedWire) and wire.bits != self.wire_bits:
            return dataclasses.replace(self, wire_bits=wire.bits).aggregate(wire, weights)
        if isinstance(wire, HeteroWire):
            return self._aggregate_hetero(wire, weights)
        if isinstance(wire, SparseWire):
            if weights is not None:
                raise TypeError("weighted aggregation needs a dense PackedWire")
            from .sparse import sparse_aggregate

            return sparse_aggregate(wire.indices, _unpack_codes(wire.packed, wire.k), wire.b, wire.d)
        if weights is not None or wire.bits > 1:
            # the count kernel has no weighted or k-bit form; the plain
            # count reads the same packed wire, as in the reference
            return super().aggregate(wire, weights)
        # The kernel wire is padded_len(d)/8 bytes; a wire from the chunked
        # packer may carry more or fewer pad bytes. Pad bits encode
        # coordinates >= d, which bit_aggregate slices off, so realigning
        # is lossless.
        packed = kops.realign_wire(wire.packed, kops.padded_len(wire.d) // 8)
        engine = self.engine if self.use_kernels else "ref"
        return kops.bit_aggregate(packed, wire.b, wire.d, engine=engine)

    def _aggregate_hetero(self, wire: HeteroWire, weights):
        """Each group's L-level estimate (plain, ``use_kernels`` off as in
        the reference), merged as ``sum_g w_g theta_g / sum_g w_g`` with
        ``w_g = M_g (2**k_g - 1)**2``: each step of the sum one fused
        multiply-add and the division a multiply by ``f32(1/sum w_g)``, as
        XLA compiles the reference's."""
        num, den, off = torch.zeros(wire.d, device=wire.wires[0].b.device), 0, 0
        for w in wire.wires:
            srv = dataclasses.replace(self, wire_bits=w.bits, use_kernels=False)
            wsel = None if weights is None else weights[off:off + w.n_clients]
            gw = w.n_clients * ((1 << w.bits) - 1) ** 2
            num = prng._fma(float(gw), srv.aggregate(w, wsel), num)
            den += gw
            off += w.n_clients
        return num * recip32(den)


@dataclasses.dataclass(frozen=True)
class SignSGDMVServer(ServerAggregator):
    """signSGD with majority vote (Bernstein et al. 2019): ``step`` times the
    sign of ``2 N_i - M`` (0 at a tie)."""

    step: float = 0.01

    def from_counts(self, counts, m, b):
        return self.step * torch.sign(2.0 * counts.float() - m)


@dataclasses.dataclass(frozen=True)
class RSAServer(ServerAggregator):
    """RSA (Li et al. 2019): ``step`` times the sum of the client signs."""

    step: float = 0.01

    def from_counts(self, counts, m, b):
        return self.step * (2.0 * counts.float() - m)


@dataclasses.dataclass(frozen=True)
class FedAvgServer(ServerAggregator):
    """Dense mean; streams as a weighted running sum."""

    stream_kind = "sum"

    def from_dense(self, updates, weights=None):
        return fedavg_aggregate(updates, weights)


@dataclasses.dataclass(frozen=True)
class FedGMServer(ServerAggregator):
    """Weiszfeld geometric median: every step reads every row, so a
    streaming round buffers all rows (memory stays O(M * d))."""

    iters: int = 16
    stream_kind = "buffer"

    def from_dense(self, updates, weights=None):
        return geometric_median(updates, self.iters, weights=weights)


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
        flip_gate=None,
        row_offset: int = 0,
    ):
        """Client half: compress every client onto the wire. ``flip_n > 0``
        arms the ``bit_flip`` adversary, which inverts
        (or, on a dense wire, negates) the rows of cohort positions below
        ``flip_n`` after compression; their residuals stay the honest ones.
        ``flip_gate`` (a bool, or one a run for a group's (E, M, d) updates)
        keeps the adversary off where it is False: a campaign group arms
        ``flip_n`` when any of its cells is a bit_flip cell, and the gate
        of each run says whether it is one. The rows are cohort positions
        ``row_offset ..``: a streaming round passes its chunk's first
        position, which keys the quantizer draws and, when it is not 0,
        flips by a row mask."""
        wire, residuals = self.compressor.compress(key, deltas, b_scalar, residuals, row_offset=row_offset)
        gate = True if flip_gate is None else flip_gate
        if flip_n and deltas.dim() == 3:
            from .attacks import flip_wire, flip_wire_rows

            runs = np.flatnonzero(np.broadcast_to(gate, deltas.shape[:1]))
            if runs.size and row_offset:
                rows = row_offset + torch.arange(deltas.shape[1], device=deltas.device)
                wire = flip_wire_rows(wire, rows < flip_n, runs=runs.tolist())
            elif runs.size:
                wire = flip_wire(wire, flip_n, runs=runs.tolist())
        elif flip_n and gate:
            from .attacks import flip_wire, flip_wire_rows

            if row_offset:
                rows = row_offset + torch.arange(deltas.shape[0], device=deltas.device)
                wire = flip_wire_rows(wire, rows < flip_n)
            else:
                wire = flip_wire(wire, flip_n)
        return wire, residuals

    def estimate(self, wire, weights: torch.Tensor | None = None) -> torch.Tensor:
        """Server half: theta_hat (d,) from the wire; ``weights``, one per
        row, selects the weighted estimate."""
        return self.server.aggregate(wire, weights)

    def __call__(self, key: torch.Tensor, deltas: torch.Tensor, b_scalar: torch.Tensor, residuals: torch.Tensor,
                 *, flip_n: int = 0, flip_gate=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole synchronous step: :meth:`compress_wire` then
        :meth:`estimate`; returns ``(theta_hat, residuals')``."""
        wire, residuals = self.compress_wire(key, deltas, b_scalar, residuals, flip_n=flip_n, flip_gate=flip_gate)
        return self.estimate(wire), residuals


def _build_probit_plus(*, dp, b_mode, error_feedback, topk_frac, use_kernels, chunk, engine, rand_bits, wire_bits,
                       client_bits, **_):
    return (
        ClientCompressor(error_feedback=error_feedback, topk_frac=topk_frac, dp=dp, b_mode=b_mode,
                         use_kernels=use_kernels, chunk=chunk, engine=engine, rand_bits=rand_bits,
                         wire_bits=wire_bits, client_bits=client_bits),
        ProBitPlusServer(use_kernels=use_kernels, engine=engine, wire_bits=wire_bits, dp=dp),
    )


_PIPELINES = {
    "probit_plus": _build_probit_plus,
    "fedavg": lambda *, chunk, **_: (ClientCompressor(mode="dense", chunk=chunk), FedAvgServer()),
    "fed_gm": lambda *, gm_iters, chunk, **_: (ClientCompressor(mode="dense", chunk=chunk),
                                               FedGMServer(iters=gm_iters)),
    "signsgd_mv": lambda *, agg_step, chunk, **_: (ClientCompressor(mode="pack_sign", chunk=chunk),
                                                   SignSGDMVServer(step=agg_step)),
    "rsa": lambda *, agg_step, chunk, **_: (ClientCompressor(mode="pack_sign", chunk=chunk),
                                            RSAServer(step=agg_step)),
}


def available_aggregators() -> tuple[str, ...]:
    return tuple(sorted(_PIPELINES))


def build_pipeline(
    name: str,
    *,
    dp: DPConfig = DPConfig(0.0),
    b_mode: str = "dynamic",
    error_feedback: bool = False,
    topk_frac: float = 1.0,
    agg_step: float = 0.01,
    gm_iters: int = 16,
    use_kernels: bool = False,
    chunk: int = PACK_CHUNK,
    engine: str | None = None,
    rand_bits: int = 32,
    wire_bits: int = 1,
    client_bits: tuple | None = None,
) -> AggregatorPipeline:
    """Resolve an aggregator name into a configured pipeline. Only PRoBit+
    reads ``dp``, ``b_mode``, ``error_feedback``, ``topk_frac``,
    ``use_kernels`` and ``rand_bits``; the sign and dense baselines ignore
    them, as in the reference, and refuse k-bit and per-client widths."""
    if rand_bits not in (16, 32):
        raise ValueError(f"rand_bits must be 16 or 32, got {rand_bits}")
    if name not in _PIPELINES:
        raise ValueError(f"unknown aggregator {name!r}; available: {available_aggregators()}")
    if (wire_bits != 1 or client_bits is not None) and name != "probit_plus":
        raise ValueError(
            f"wire_bits > 1 / per-client bit-widths are only supported by the probit_plus wire, got {name!r}"
        )
    compressor, server = _PIPELINES[name](
        dp=dp, b_mode=b_mode, error_feedback=error_feedback, topk_frac=topk_frac, agg_step=agg_step,
        gm_iters=gm_iters, use_kernels=use_kernels, chunk=chunk, engine=engine, rand_bits=rand_bits,
        wire_bits=wire_bits, client_bits=client_bits,
    )
    return AggregatorPipeline(name=name, compressor=compressor, server=server)
