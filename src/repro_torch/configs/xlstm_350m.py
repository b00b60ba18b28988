"""xLSTM-350M [arXiv:2405.04517] — 7:1 mLSTM:sLSTM blocks, no separate FFN
(the blocks carry their own up/down projections)."""

from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        rope=False,
        pattern=("mlstm",) * 7 + ("slstm",),
        proj_factor=2.0,
    )
