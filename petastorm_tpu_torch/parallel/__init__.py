"""Mesh- and process-aware sharding helpers over ``torch.distributed``.

Counterpart of ``petastorm_tpu/parallel``: shard assignment comes from the
process group (one process per card), batch placements from a
``DeviceMesh`` with named dimensions.
"""

from petastorm_tpu_torch.parallel.mesh import (data_parallel_mesh, local_data_slice,
                                               shard_options_from_torch, sharding_for_batch)
from petastorm_tpu_torch.parallel.write import distributed_write_dataset

__all__ = ["data_parallel_mesh", "shard_options_from_torch", "sharding_for_batch",
           "local_data_slice", "distributed_write_dataset"]
