"""Models of the port: the paper's MLP, CNN and ResNet, and the model zoo's
dense attention, MoE, xLSTM, Mamba-hybrid, audio and vision families
(``repro/models``' names, decode and caches included), with the model
axis's sharding helpers: parameter specs and placements, abstract
parameters and inputs, the caches' logical axes and the remat levers. The
logical-axis rules are in :mod:`repro_torch.distributed`."""

from . import layers, moe, ssm, xlstm

from .config import SHAPES, ModelConfig, ShapeConfig
from .inputs import batch_structure, input_logical, input_specs, sample_batch
from .model import (
    backbone,
    build_specs,
    cache_logical,
    indexed_params,
    init_cache,
    inner_remat,
    prefill,
    remat_policy,
    serve_step,
    train_loss,
)
from .spec import LeafSpec, abstract_params, count_params, init_params, param_placements, param_pspecs
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
    "init_params", "count_params", "abstract_params", "param_pspecs", "param_placements",
    "build_specs", "train_loss", "prefill", "backbone", "init_cache", "cache_logical", "serve_step",
    "remat_policy", "inner_remat", "indexed_params",
    "sample_batch", "batch_structure", "input_specs", "input_logical",
    "layers", "moe", "ssm", "xlstm",
]
