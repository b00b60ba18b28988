"""Models of the port: the paper's MLP, CNN and ResNet."""

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
]
