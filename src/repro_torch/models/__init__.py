"""Models of the port (the paper's MLP so far)."""

from .vision import accuracy, init_mlp, mlp_logits, xent_loss

__all__ = ["init_mlp", "mlp_logits", "xent_loss", "accuracy"]
