"""Launch layer: the federated LM round and its training entry point
(``python -m repro_torch.launch.train``). The reference's production mesh
and dry-run tooling come with ROADMAP A14."""

from .fl_step import DistFLConfig, make_fl_train_step

__all__ = ["DistFLConfig", "make_fl_train_step"]
