"""The (data, disp) mesh of the processes (port of dcanet_tpu/parallel/mesh.py).

The JAX package lays a (data, disp) grid over its devices and lets XLA
shard the batch over `data` and the cost volume's disparity axis over
`disp`. Here one process drives one card, and the grid is laid over the
process group as the JAX package lays it over its devices: process
p = data * n_disp + disp. Data rank i holds rows [i * b, (i + 1) * b) of a
global batch of n_data * b rows, the same rows on each disp rank of its
row of the grid; disp rank j holds its planes of every volume
(`parallel/sharding.py`), exchanged within the row's disp subgroup
(`disp_group`; the world where n_data = 1). Every other sum (BatchNorm's
statistics, the loss counts, the gradients) runs over the world.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from dcanet_tpu_torch.parallel.distributed import new_subgroups, process_count, process_index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid's extents, this process's place on the data axis (`rank`)
    and on the disp axis (`disp_rank`), and the process group of its row's
    disp ranks (`disp_group`; None: the world)."""

    n_data: int
    n_disp: int
    rank: int
    disp_rank: int = 0
    disp_group: Any = dataclasses.field(default=None, compare=False, repr=False)


def make_mesh(n_data: Optional[int] = None, n_disp: int = 1) -> Mesh:
    """The (data, disp) grid of the ranks: n_data x n_disp must equal the
    number of processes (one process per card, no idle one). `n_data`
    defaults to the processes over n_disp. With both axes above 1 every
    rank forms the n_data disp subgroups, in order, and keeps its own."""
    world = process_count()
    axis = "data axis" if n_disp == 1 else "disp axis" if n_data in (None, 1) else "data x disp grid"
    asked = n_data
    n_data = world // max(n_disp, 1) if n_data is None else n_data
    if n_disp < 1 or n_data < 1 or n_data * n_disp != world:
        raise ValueError(
            f"mesh data={asked} disp={n_disp} over {world} process(es): the {axis} must equal the number "
            "of processes (one per card)"
        )
    p = process_index()
    group = None
    if n_data > 1 and n_disp > 1:
        group = new_subgroups(range(i * n_disp, (i + 1) * n_disp) for i in range(n_data))
    return Mesh(n_data=n_data, n_disp=n_disp, rank=p // n_disp, disp_rank=p % n_disp, disp_group=group)


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
    """Rank 0's parameters and buffers on every rank of the grid (in place),
    on the data axis and the disp axis alike: one broadcast of each dtype's
    tensors, flattened in state_dict order. Nothing on a grid of one."""
    if mesh.n_data * mesh.n_disp == 1:
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
