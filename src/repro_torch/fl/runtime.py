"""FL simulation runtime: the stateful harness around the rounds.

Counterpart of ``repro/fl/runtime.py``. :class:`FLConfig` keeps every field
of the reference's config, so a config carries over unchanged, and rejects
what the reference rejects with the same ``ValueError``. :class:`FLSimulation`
runs the round the config calls for (synchronous, streamed over
``client_chunk`` clients, buffered-asynchronous or a hierarchical tree,
:func:`~repro_torch.fl.rounds.round_fn`) on any of
the wires (one-bit, k-bit, mixed-width, top-k, dense) with the
reference's key schedule (``key = PRNGKey(seed)``; each round
``key, kb, kr = split(key, 3)``; batches from ``kb``, the round from
``kr``), on the card unless ``device="cpu"`` is passed. ``stream_shard``
and ``tree_shard`` spread the streamed cohort or the tree's edges over the
ranks of a process group (:mod:`repro_torch.distributed`): every rank
builds the same simulation and runs its slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch

from .. import prng
from ..core import (
    ACCOUNTANTS,
    STREAM_ATTACKS,
    BControlConfig,
    DPConfig,
    PrivacyLedger,
    available_aggregators,
    build_pipeline,
    is_timing_attack,
    is_wire_attack,
    parse_attack,
)
from . import rounds as _rounds

__all__ = ["FLConfig", "FLSimulation"]

_B_MODES = ("dynamic", "fixed", "oracle")

# Aggregators whose estimate streams as additive vote counts (a tree's edges
# ship count tensors).
_COUNT_STREAM_AGGREGATORS = ("probit_plus", "signsgd_mv", "rsa")


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The reference's FL config; see ``repro/fl/runtime.py`` for each field."""

    n_clients: int = 20
    byz_frac: float = 0.0
    attack: str = "none"
    aggregator: str = "probit_plus"
    rounds: int = 30
    local_epochs: int = 5
    batch_size: int = 10
    lr: float = 0.01
    momentum: float = 0.5
    lam: float = 0.2
    dp_epsilon: float = 0.0  # 0 disables DP
    l1_sensitivity: float = 2e-4
    b_mode: str = "dynamic"
    b_init: float = 0.01
    error_feedback: bool = False
    topk_frac: float = 1.0
    participation: float = 1.0
    dp_accountant: str = "subsampled"
    async_buffer: int = 0
    async_latency: float = 0.0
    staleness_decay: float = 0.0
    agg_step: float = 0.01
    gm_iters: int = 16
    use_kernels: bool = False
    client_chunk: int = 0
    stateless_clients: bool = False
    pack_chunk: int = 0
    stream_shard: bool = False
    wire_bits: int = 1
    client_bits: tuple | None = None
    tree_edges: int = 0
    edge_buffer: int = 0
    tree_shard: bool = False
    byz_edges: int = 0
    edge_attack: str = "none"
    edge_merge: str = "sum"
    edge_trim: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.aggregator not in available_aggregators():
            raise ValueError(
                f"unknown aggregator {self.aggregator!r}; available: {available_aggregators()}"
            )
        parse_attack(self.attack)  # ValueError on unknown names
        if self.dp_accountant not in ACCOUNTANTS:
            raise ValueError(f"unknown dp_accountant {self.dp_accountant!r}; available: {ACCOUNTANTS}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got {self.participation}")
        if self.b_mode not in _B_MODES:
            raise ValueError(f"unknown b_mode {self.b_mode!r}; available: {_B_MODES}")
        if self.topk_frac < 1.0 and self.dp_epsilon > 0:
            raise ValueError(
                "topk_frac < 1 releases a data-dependent index set and breaks the (eps,0)-DP guarantee; use "
                "dense PRoBit+ with DP."
            )
        self._check_async_and_stream()
        self._check_wires()
        self._check_stream_shard()
        self._check_tree()

    def _check_async_and_stream(self):
        """The reference's checks of the asynchronous and streaming fields."""
        if self.async_buffer < 0:
            raise ValueError(f"async_buffer must be >= 0, got {self.async_buffer}")
        if self.async_latency < 0:
            raise ValueError(f"async_latency must be >= 0, got {self.async_latency}")
        if self.staleness_decay < 0:
            raise ValueError(
                f"staleness_decay must be >= 0 (weights must be monotone non-increasing in age), "
                f"got {self.staleness_decay}"
            )
        if not self.async_buffer:
            if (self.async_latency > 0 or self.staleness_decay > 0) and not self.edge_buffer:
                raise ValueError(
                    "async_latency/staleness_decay require buffered-async rounds (set async_buffer > 0 for "
                    "client rounds or edge_buffer > 0 for a buffered-async tree root)"
                )
            if is_timing_attack(self.attack):
                raise ValueError(
                    f"timing attack {self.attack!r} needs asynchronous rounds (set async_buffer > 0); "
                    "synchronous rounds have no arrival schedule to attack"
                )
        else:
            if self.participation < 1.0:
                raise ValueError(
                    "async rounds require participation == 1.0: buffer slots, staleness ages and the "
                    "straggler gate are keyed to client identity; model partial availability with "
                    "async_latency instead"
                )
            if self.topk_frac < 1.0:
                raise ValueError("async rounds buffer dense packed wires; topk_frac < 1 (SparseWire) cannot be "
                                 "staleness-buffered")
            if self.async_buffer > self.n_active:
                raise ValueError(
                    f"async_buffer={self.async_buffer} exceeds the cohort ({self.n_active} clients); "
                    "slots beyond one per client would never be written"
                )
        if self.client_chunk < 0:
            raise ValueError(f"client_chunk must be >= 0, got {self.client_chunk}")
        if self.pack_chunk < 0 or self.pack_chunk % 8:
            raise ValueError(f"pack_chunk must be a non-negative multiple of 8, got {self.pack_chunk}")
        if self.client_chunk:
            if self.async_buffer:
                raise ValueError(
                    "client_chunk streams the synchronous round; the buffered-async server holds a "
                    "persistent wire buffer and cannot stream (set async_buffer=0)"
                )
            if self.topk_frac < 1.0:
                raise ValueError("client_chunk requires the dense packed wire; topk_frac < 1 (SparseWire) has no "
                                 "count accumulator")
            if self.b_mode == "oracle":
                raise ValueError(
                    "b_mode='oracle' maxes |delta| over the full cohort and cannot stream; use 'dynamic' or "
                    "'fixed' with client_chunk"
                )
            if self.byz_frac > 0 and parse_attack(self.attack)[0] not in STREAM_ATTACKS:
                raise ValueError(
                    f"attack {self.attack!r} colludes across the cohort and cannot run under a client-chunk "
                    f"scan; streamable attacks: {tuple(sorted(STREAM_ATTACKS))}"
                )
        if self.stateless_clients:
            if not self.client_chunk:
                raise ValueError("stateless_clients requires client_chunk > 0")
            if self.error_feedback:
                raise ValueError(
                    "error feedback carries a per-client residual across rounds and contradicts "
                    "stateless_clients"
                )

    def _check_wires(self):
        """The reference's checks of the k-bit and per-client widths."""
        from ..core.quantizer import WIRE_BITS

        if self.wire_bits not in WIRE_BITS:
            raise ValueError(f"wire_bits must be one of {WIRE_BITS}, got {self.wire_bits}")
        if self.wire_bits != 1:
            if self.aggregator != "probit_plus":
                raise ValueError(
                    f"wire_bits={self.wire_bits} is only supported by the probit_plus wire, not "
                    f"{self.aggregator!r} (the k-bit level protocol is PRoBit+'s count/MLE machinery)"
                )
            if self.topk_frac < 1.0:
                raise ValueError(
                    "wire_bits > 1 is not supported on the top-k wire (SparseWire packs one bit per surviving "
                    "coordinate); set topk_frac=1.0"
                )
        if self.client_bits is None:
            return
        object.__setattr__(self, "client_bits", tuple(int(k) for k in self.client_bits))
        for k in self.client_bits:
            if k not in WIRE_BITS:
                raise ValueError(f"client_bits entries must be in {WIRE_BITS}, got {k}")
        if self.aggregator != "probit_plus":
            raise ValueError(f"per-client bit-widths (client_bits) are only supported by probit_plus, not "
                             f"{self.aggregator!r}")
        if len(self.client_bits) != self.n_active:
            raise ValueError(
                f"client_bits needs one entry per cohort row: got {len(self.client_bits)} for a "
                f"{self.n_active}-client cohort"
            )
        if self.use_kernels:
            raise ValueError(
                "client_bits is not supported on the kernel wire yet; unset use_kernels (homogeneous wire_bits "
                "works with kernels)"
            )
        if self.topk_frac < 1.0:
            raise ValueError("client_bits is not supported on the top-k wire; set topk_frac=1.0")
        if self.client_chunk or self.stream_shard:
            raise ValueError(
                "client_bits emits a per-group HeteroWire and cannot stream through the flat count accumulator; "
                "unset client_chunk/stream_shard"
            )
        if self.async_buffer:
            raise ValueError(
                "client_bits rows have heterogeneous wire widths and cannot share the fixed-width async buffer; "
                "set async_buffer=0"
            )
        if self.byz_frac > 0 and is_wire_attack(self.attack):
            raise ValueError(
                f"wire attack {self.attack!r} is not supported on the heterogeneous wire yet; use a delta-level "
                "attack or homogeneous wire_bits"
            )

    def _check_stream_shard(self):
        """The reference's checks of the sharded streaming round."""
        if not self.stream_shard:
            return
        if not self.client_chunk:
            raise ValueError("stream_shard requires client_chunk > 0")
        if not self.stateless_clients:
            raise ValueError(
                "stream_shard requires stateless_clients: scattering per-client state back from device-local "
                "chunk rows is not supported"
            )
        if self.participation < 1.0:
            raise ValueError(
                "stream_shard requires participation == 1.0 (the static client-data shard layout cannot "
                "follow a resampled cohort)"
            )
        if self.aggregator == "fed_gm":
            raise ValueError(
                "fed_gm buffers all rows (stream_kind='buffer') and cannot reduce across shards; pick a "
                "count- or sum-streaming aggregator"
            )

    def _check_tree(self):
        """The reference's checks of the hierarchical tree's fields."""
        if self.tree_edges < 0:
            raise ValueError(f"tree_edges must be >= 0, got {self.tree_edges}")
        if self.edge_buffer < 0:
            raise ValueError(f"edge_buffer must be >= 0, got {self.edge_buffer}")
        if not self.tree_edges:
            tree_only = {
                "edge_buffer": (self.edge_buffer, 0),
                "tree_shard": (self.tree_shard, False),
                "byz_edges": (self.byz_edges, 0),
                "edge_attack": (self.edge_attack, "none"),
                "edge_merge": (self.edge_merge, "sum"),
                "edge_trim": (self.edge_trim, 0),
            }
            for name, (val, default) in tree_only.items():
                if val != default:
                    raise ValueError(f"{name}={val!r} requires a hierarchical tree round (set tree_edges > 0)")
            return
        from ..core.attacks import EDGE_ATTACK_IDS
        from .hierarchy import EDGE_MERGES

        if self.aggregator not in _COUNT_STREAM_AGGREGATORS:
            raise ValueError(
                f"tree_edges requires a count-streaming aggregator (edges ship additive count tensors); "
                f"{self.aggregator!r} is not in {_COUNT_STREAM_AGGREGATORS}"
            )
        if not self.client_chunk:
            raise ValueError(
                "tree_edges requires client_chunk > 0: each edge runs the chunked count-accumulation scan over "
                "its slice"
            )
        if self.tree_edges > self.n_active:
            raise ValueError(
                f"tree_edges={self.tree_edges} exceeds the cohort ({self.n_active} clients); an edge needs at "
                "least one client"
            )
        if self.async_buffer:
            raise ValueError(
                "tree_edges and async_buffer are exclusive: the tree buffers *edge count tensors* at the root "
                "(edge_buffer), not client wire rows"
            )
        if self.stream_shard:
            raise ValueError("tree_edges shards by edge (tree_shard), not by the flat client axis; unset "
                             "stream_shard")
        if self.edge_buffer > self.tree_edges:
            raise ValueError(
                f"edge_buffer={self.edge_buffer} exceeds tree_edges={self.tree_edges}; slots beyond one per edge "
                "would never be written"
            )
        if self.edge_attack not in EDGE_ATTACK_IDS:
            raise ValueError(f"unknown edge_attack {self.edge_attack!r}; available: {EDGE_ATTACK_IDS}")
        if not 0 <= self.byz_edges <= self.tree_edges:
            raise ValueError(
                f"byz_edges must be in [0, tree_edges], got {self.byz_edges} with tree_edges={self.tree_edges}"
            )
        if self.byz_edges and self.edge_attack == "none":
            raise ValueError(f"byz_edges > 0 needs an edge_attack from {EDGE_ATTACK_IDS[1:]}")
        if self.edge_attack == "edge_replay" and not self.edge_buffer:
            raise ValueError(
                "edge_replay re-ships the root's buffered slot content and needs a buffered tree (set "
                "edge_buffer > 0)"
            )
        if self.edge_merge not in EDGE_MERGES:
            raise ValueError(f"unknown edge_merge {self.edge_merge!r}; available: {EDGE_MERGES}")
        if self.edge_merge != "sum" and self.edge_buffer:
            raise ValueError(
                "robust edge merges (median/trimmed) operate on fresh edge tensors; staleness-weighted robust "
                "merging is not supported (set edge_buffer=0)"
            )
        if self.edge_trim and self.edge_merge != "trimmed":
            raise ValueError("edge_trim only applies to edge_merge='trimmed'")
        if self.edge_merge == "trimmed" and 2 * self.edge_trim >= self.tree_edges:
            raise ValueError(
                f"edge_trim={self.edge_trim} trims away all {self.tree_edges} edges (need 2*edge_trim < "
                "tree_edges)"
            )
        if self.tree_shard:
            if not self.stateless_clients:
                raise ValueError(
                    "tree_shard requires stateless_clients: scattering per-client state back from device-local "
                    "edge slices is not supported"
                )
            if self.participation < 1.0:
                raise ValueError(
                    "tree_shard requires participation == 1.0 (the static client-data shard layout cannot "
                    "follow a resampled cohort)"
                )
            if self.n_active % self.tree_edges:
                raise ValueError(
                    f"tree_shard needs equal edge slices: tree_edges={self.tree_edges} does not divide the "
                    f"{self.n_active}-client cohort"
                )

    @property
    def n_active(self) -> int:
        return max(int(self.n_clients * self.participation), 1)

    @property
    def n_byz(self) -> int:
        return int(self.n_clients * self.byz_frac)

    @property
    def dp(self) -> DPConfig:
        return DPConfig(self.dp_epsilon, self.l1_sensitivity)

    @property
    def sampling_rate(self) -> float:
        """Client sampling rate ``q``: 1.0 at full participation."""
        return 1.0 if self.participation >= 1.0 else self.n_active / self.n_clients

    def ledger(self) -> PrivacyLedger:
        return PrivacyLedger(eps_per_round=self.dp_epsilon, q=self.sampling_rate, accountant=self.dp_accountant)

    @property
    def bctrl(self) -> BControlConfig:
        return BControlConfig(self.b_mode, self.b_init)

    def pipeline(self, engine: str | None = None):
        """The aggregation pipeline of this run; ``engine`` forces the
        kernel engine of every ``ops`` call."""
        from ..core.quantizer import PACK_CHUNK

        return build_pipeline(
            self.aggregator,
            dp=self.dp,
            b_mode=self.b_mode,
            error_feedback=self.error_feedback,
            topk_frac=self.topk_frac,
            agg_step=self.agg_step,
            gm_iters=self.gm_iters,
            use_kernels=self.use_kernels,
            chunk=self.pack_chunk or PACK_CHUNK,
            engine=engine,
            wire_bits=self.wire_bits,
            client_bits=self.client_bits,
        )


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "FLSimulation runs on the card by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


class FLSimulation:
    """The experiment harness: owns the run's state (a
    :class:`~repro_torch.fl.rounds.RoundState`, or an
    :class:`~repro_torch.fl.rounds.AsyncRoundState`) and runs one round of
    the config's kind per loop iteration, evaluating every ``eval_every``
    rounds.

    ``device`` defaults to the card and raises when there is none;
    ``engine`` (``"cuda"`` or ``"ref"``) forces the kernel engine down to
    every ``ops`` call, e.g. to run the plain versions on the card.
    """

    def __init__(
        self,
        cfg: FLConfig,
        init_params,
        loss_fn: Callable,
        acc_fn: Callable,
        client_x,
        client_y,
        test: dict,
        *,
        device=None,
        engine: str | None = None,
    ):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else _default_device()
        self.ctx = _rounds.make_context(
            cfg, init_params, loss_fn, acc_fn, client_x, client_y, test,
            device=self.device, engine=engine,
        )
        self.state = _rounds.init_run_state(self.ctx)
        self._round = _rounds.round_fn(self.ctx)
        self._params = _rounds.cell_params(cfg)
        self.history: list[dict] = []
        self.ledger = cfg.ledger()

    @property
    def w_global(self) -> torch.Tensor:
        return self.state.w_global

    @property
    def w_locals(self) -> torch.Tensor:
        return self.state.w_locals

    @property
    def b_state(self):
        return self.state.b

    @property
    def residuals(self) -> torch.Tensor:
        return self.state.residuals

    @property
    def pipeline(self):
        return self.ctx.pipeline

    @property
    def d(self) -> int:
        return self.ctx.d

    @property
    def eps_trajectory(self):
        """Cumulative DP budget after each executed round."""
        return self.ledger.trajectory()

    def evaluate(self) -> float:
        return _rounds.evaluate(self.ctx, self.w_global)

    def iter_rounds(self, rounds: int | None = None) -> Iterator[tuple[int, dict]]:
        """Run ``rounds`` rounds from ``PRNGKey(seed)``, yielding
        ``(t, metrics)`` after each (metrics as tensors, theta included)."""
        rounds = rounds or self.cfg.rounds
        key = prng.key(self.cfg.seed, self.device)
        for t in range(rounds):
            key, kb, kr = prng.split(key, 3)
            batches = _rounds.round_batches(self.ctx, kb)
            self.state, metrics = self._round(self.ctx, self._params, kr, self.state, batches)
            self.ledger.record_round()
            yield t, metrics

    def run(self, rounds: int | None = None, eval_every: int = 5, verbose: bool = False):
        cfg = self.cfg
        rounds = rounds or cfg.rounds
        for t, metrics in self.iter_rounds(rounds):
            if (t + 1) % eval_every == 0 or t == rounds - 1:
                rec = {
                    "round": t + 1,
                    "acc": self.evaluate(),
                    "loss": float(metrics["loss"]),
                    "b": float(self.state.b.b),
                    "eps_spent": self.ledger.eps_spent,
                }
                self.history.append(rec)
                if verbose:
                    print(
                        f"[{cfg.aggregator}|{cfg.attack}|byz={cfg.byz_frac:.0%}] "
                        f"round {t+1}: acc={rec['acc']:.4f} loss={rec['loss']:.4f} "
                        f"b={rec['b']:.5f} eps={rec['eps_spent']:.4g}"
                    )
        return self.history
