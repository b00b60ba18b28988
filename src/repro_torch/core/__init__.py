"""PRoBit+ core: quantizer, aggregation pipeline, b-controller, attacks,
privacy (counterpart of ``repro/core`` for the slice ported so far)."""

from .aggregation import (
    AggregatorPipeline,
    ClientCompressor,
    PackedWire,
    ProBitPlusServer,
    ServerAggregator,
    available_aggregators,
    build_pipeline,
    ml_estimate_from_counts,
)
from .attacks import ATTACK_IDS, apply_attack, attack_id, flip_wire, is_timing_attack, is_wire_attack, parse_attack
from .bcontrol import BControlConfig, BState, init_b_state, loss_bit, update_b, update_b_from_vote
from .ledger import ACCOUNTANTS, PrivacyLedger
from .privacy import DPConfig, dp_b_floor
from .quantizer import PACK_CHUNK, binarize_prob, packed_binarize_batch, packed_counts, padded_dim, wire_bytes

__all__ = [
    "AggregatorPipeline",
    "ClientCompressor",
    "PackedWire",
    "ProBitPlusServer",
    "ServerAggregator",
    "available_aggregators",
    "build_pipeline",
    "ml_estimate_from_counts",
    "ATTACK_IDS",
    "apply_attack",
    "attack_id",
    "flip_wire",
    "is_timing_attack",
    "is_wire_attack",
    "parse_attack",
    "BControlConfig",
    "BState",
    "init_b_state",
    "loss_bit",
    "update_b",
    "update_b_from_vote",
    "ACCOUNTANTS",
    "PrivacyLedger",
    "DPConfig",
    "dp_b_floor",
    "PACK_CHUNK",
    "binarize_prob",
    "packed_binarize_batch",
    "packed_counts",
    "padded_dim",
    "wire_bytes",
]
