"""Launch layer: the federated LM round and its training entry point
(``python -m repro_torch.launch.train``), and the meshes of
``torch.distributed`` ranks (:mod:`.mesh`) on which the round's pod axis,
the sharded streamed and tree rounds and sharded campaigns spread their
clients (ROADMAP A14a). The production mesh's model axis and the dry-run
tooling come with ROADMAP A14b."""

from .fl_step import DistFLConfig, make_fl_train_step

__all__ = ["DistFLConfig", "make_fl_train_step"]
