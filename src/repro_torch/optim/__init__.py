"""SGD with momentum and the local solvers."""

from .sgd import local_prox_train, sgd_momentum_init, sgd_momentum_step

__all__ = ["sgd_momentum_init", "sgd_momentum_step", "local_prox_train"]
