"""Local solvers."""

from .sgd import local_prox_train

__all__ = ["local_prox_train"]
