"""Multi-process execution (port of dcanet_tpu/parallel/), one process per
card: data-parallel training (one model, one global batch) and the
disparity-axis sharding of eval (`make_disp_constraint`)."""

from dcanet_tpu_torch.parallel.distributed import (
    all_reduce_sum, initialize, process_count, process_index, shutdown, sync_hosts,
)
from dcanet_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch
from dcanet_tpu_torch.parallel.sharding import DispPlan, DispShard, make_disp_constraint

__all__ = [
    "DispPlan", "DispShard", "Mesh", "all_reduce_sum", "initialize", "make_disp_constraint", "make_mesh",
    "process_count", "process_index", "replicate", "shard_batch", "shutdown", "sync_hosts",
]
