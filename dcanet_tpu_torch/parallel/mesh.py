"""The data-parallel mesh (port of dcanet_tpu/parallel/mesh.py).

The JAX package lays a (data, disp) grid over its devices and lets XLA
shard the batch over `data`. Here one process drives one card, so the data
axis is the process group itself: rank r holds rows [r * b, (r + 1) * b) of
a global batch of n_data * b rows, and the disp axis is 1 (disparity-axis
sharding is ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from dcanet_tpu_torch.parallel.distributed import process_count, process_index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid's extents and this process's place on the data axis."""

    n_data: int
    n_disp: int
    rank: int


def make_mesh(n_data: Optional[int] = None, n_disp: int = 1) -> Mesh:
    """The (data, disp) grid of the ranks. `n_data` defaults to the number of
    processes and must equal it (one process per card, no idle one);
    `n_disp` > 1 is not ported yet."""
    if n_disp > 1:
        raise NotImplementedError(
            f"n_disp_shards={n_disp}: disparity-axis sharding is not ported yet (ROADMAP Queue 1 item 3)"
        )
    world = process_count()
    n_data = world if n_data is None else n_data
    if n_disp < 1 or n_data != world:
        raise ValueError(
            f"mesh data={n_data} disp={n_disp} over {world} process(es): the data axis must equal the number "
            "of processes (one per card) and disp must be 1"
        )
    return Mesh(n_data=n_data, n_disp=n_disp, rank=process_index())


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch dict (leading axis over `data`)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.n_data:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not divisible by data={mesh.n_data}")
        b = v.shape[0] // mesh.n_data
        out[k] = v[mesh.rank * b : (mesh.rank + 1) * b]
    return out


@torch.no_grad()
def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Rank 0's parameters and buffers on every rank (in place): one
    broadcast of each dtype's tensors, flattened in state_dict order."""
    if mesh.n_data == 1:
        return module
    by_dtype: Dict[torch.dtype, list] = {}
    for t in module.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0)
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))
    return module
