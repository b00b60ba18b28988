"""Unified architecture configuration for the 10 assigned architectures
(a plain copy of ``repro/models/config.py``; the port imports nothing of
the JAX package).

A model is a repeated *pattern unit* of blocks. Each block has a mixer
(attn | mamba | mlstm | slstm) and an FFN (dense | moe | none). The pattern
abstraction lets one scan-based forward cover dense, MoE, SSM, and hybrid
(Jamba-style 1:7 interleave) architectures with stacked per-position
parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mamba", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention
    rope: bool = True
    rope_theta: float = 1e6
    qkv_bias: bool = False
    causal: bool = True
    sliding_window: int = 0  # 0 = full attention; >0 native window

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1  # layer l uses MoE iff n_experts>0 and l % moe_every == moe_every-1
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # pattern of mixers, tiled to n_layers (len must divide n_layers)
    pattern: tuple[str, ...] = ("attn",)

    ffn_act: str = "swiglu"  # swiglu | gelu
    encoder_only: bool = False
    frontend: str = "none"  # none | audio | vision
    frontend_tokens: int = 0  # patches (vlm) / all frames (audio)

    # SSM (mamba)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    # xLSTM
    proj_factor: float = 2.0

    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def reps(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (self.name, self.pattern)
        return self.n_layers // len(self.pattern)

    @property
    def unit(self) -> int:
        return len(self.pattern)

    def mixer_at(self, pos: int) -> str:
        return self.pattern[pos]

    def ffn_at(self, pos: int) -> str:
        """FFN kind at pattern position (consistent across reps because
        unit % moe_every == 0 is asserted for MoE models)."""
        if self.d_ff == 0 and self.moe_d_ff == 0:
            return "none"
        if self.n_experts > 0:
            assert self.unit % self.moe_every == 0 or self.moe_every % self.unit == 0
            if pos % self.moe_every == self.moe_every - 1:
                return "moe"
            return "dense" if self.d_ff > 0 else "none"
        return "dense"

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d  # embedding
        if not self.tie_embeddings and not self.encoder_only:
            total += d * self.vocab  # head
        if self.encoder_only:
            total += d * self.vocab  # classifier
        for l in range(self.n_layers):
            pos = l % self.unit
            mix = self.mixer_at(pos)
            if mix == "attn":
                total += d * (self.n_heads * hd) * 2  # wq, wo
                total += d * (self.n_kv_heads * hd) * 2  # wk, wv
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif mix == "mamba":
                din = self.expand * d
                dtr = max(d // 16, 1)
                total += d * 2 * din + self.d_conv * din + din
                total += din * (dtr + 2 * self.d_state) + dtr * din + din
                total += din * self.d_state + din + din * d
            elif mix == "mlstm":
                dup = int(self.proj_factor * d)
                total += d * 2 * dup + self.d_conv * dup
                total += 3 * dup * dup + 3 * dup  # q,k,v + gates
                total += dup * d
            elif mix == "slstm":
                total += 4 * d * d + 4 * d  # i,f,z,o proj
                total += 4 * d * (d // max(self.n_heads, 1))  # recurrent per head
                total += d * d
            f = self.ffn_at(pos)
            if f == "dense":
                mult = 3 if self.ffn_act == "swiglu" else 2
                total += mult * d * self.d_ff
            elif f == "moe":
                mult = 3 if self.ffn_act == "swiglu" else 2
                total += self.n_experts * mult * d * self.moe_d_ff + d * self.n_experts
                if self.shared_expert:
                    total += mult * d * self.moe_d_ff
            total += 2 * d  # norms
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameters — MoE counts top_k experts only."""
        if self.n_experts == 0:
            return self.n_params()
        total = self.n_params()
        mult = 3 if self.ffn_act == "swiglu" else 2
        n_moe_layers = sum(
            1 for l in range(self.n_layers) if self.ffn_at(l % self.unit) == "moe"
        )
        inactive = n_moe_layers * (self.n_experts - self.top_k) * mult * self.d_model * self.moe_d_ff
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
