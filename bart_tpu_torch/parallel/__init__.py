"""Multi-device execution on torch.distributed: the (chain, wn) mesh of
ranks (mesh.py), process-group start-up (distributed.py) and the twin of
the JAX package's multi-chip dryrun (dryrun.py)."""

from bart_tpu_torch.parallel.distributed import (init_distributed,
                                                 is_multihost, local_device)
from bart_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                          pad_tables_for_mesh, shard_model,
                                          shard_tables, table_shardings)

__all__ = ["init_distributed", "is_multihost", "local_device", "Mesh",
           "make_mesh", "table_shardings", "pad_tables_for_mesh",
           "shard_tables", "shard_model"]
