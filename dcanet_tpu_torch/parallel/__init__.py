"""Data-parallel training across processes (port of dcanet_tpu/parallel/):
one process per card, one model, one global batch. Disparity-axis sharding
(`make_disp_constraint`) is not ported yet (ROADMAP Queue 1 item 3)."""

from dcanet_tpu_torch.parallel.distributed import (
    all_reduce_sum, initialize, process_count, process_index, shutdown, sync_hosts,
)
from dcanet_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch

__all__ = [
    "Mesh", "all_reduce_sum", "initialize", "make_mesh", "process_count", "process_index", "replicate",
    "shard_batch", "shutdown", "sync_hosts",
]
