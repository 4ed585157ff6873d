"""Multi-device parallelism of the port (port of `avsync/parallel/`): one
process per device over torch.distributed, the rank mesh and its sharding
rules (`mesh`), the process group and its collectives (`multihost`), and
the context-parallel GRU chain (`context`)."""

from avsync_torch.parallel import multihost
from avsync_torch.parallel.mesh import (Mesh, lipnet_param_spec, make_hierarchical_mesh,
                                        make_mesh, shard_model)

__all__ = ["Mesh", "make_mesh", "make_hierarchical_mesh", "lipnet_param_spec",
           "shard_model", "multihost"]
