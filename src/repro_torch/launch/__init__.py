"""Launch layer: the federated LM round and its training entry point
(``python -m repro_torch.launch.train``), the meshes of
``torch.distributed`` ranks (:mod:`.mesh`) on which the round's pod axis,
the sharded streamed and tree rounds and sharded campaigns spread their
clients and the model axis shards the parameters, and the dry run
(``python -m repro_torch.launch.dryrun``: a step traced on the production
mesh of a fake process group, with :mod:`.flopcount` and
:mod:`.analysis`)."""

from .fl_step import DistFLConfig, make_fl_train_step
from .mesh import make_host_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "DistFLConfig", "make_fl_train_step"]
