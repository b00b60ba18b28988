"""Models of the port: the paper's MLP, CNN and ResNet, and the model zoo's
dense attention, MoE, xLSTM, Mamba-hybrid, audio and vision families
(``repro/models``' names as far as they are ported, decode and caches
included). The logical-axis rules are in :mod:`repro_torch.distributed`;
the model axis's sharding helpers (parameter and input specs) come with
ROADMAP A14b."""

from . import layers, moe, ssm, xlstm

from .config import SHAPES, ModelConfig, ShapeConfig
from .inputs import batch_structure, sample_batch
from .model import backbone, build_specs, init_cache, prefill, serve_step, train_loss
from .spec import LeafSpec, count_params, init_params
from .vision import (
    MODELS,
    accuracy,
    cnn_logits,
    init_cnn,
    init_mlp,
    init_resnet,
    mlp_logits,
    resnet_logits,
    xent_loss,
)

__all__ = [
    "init_mlp", "mlp_logits",
    "init_cnn", "cnn_logits",
    "init_resnet", "resnet_logits",
    "MODELS", "xent_loss", "accuracy",
    "ModelConfig", "ShapeConfig", "SHAPES", "LeafSpec",
    "init_params", "count_params",
    "build_specs", "train_loss", "prefill", "backbone", "init_cache", "serve_step",
    "sample_batch", "batch_structure",
    "layers", "moe", "ssm", "xlstm",
]
