"""Process-group start-up and the collectives of data-parallel training
(port of dcanet_tpu/parallel/distributed.py).

The JAX package runs one SPMD program over every device, and XLA inserts
the cross-device sums. Here each card has its own process, and the sums are
explicit:

  * `initialize()` forms the process group from the JAX package's variables
    (`DCANET_COORDINATOR` host:port, `DCANET_NUM_PROCESSES`,
    `DCANET_PROCESS_ID`): NCCL for a CUDA device, gloo for the CPU;
  * `sync_hosts()` is a barrier (around checkpoints); `shutdown()` leaves
    the group at the end of a program;
  * `all_reduce_sum(t, group)` sums over the ranks, or over a subgroup's,
    and its gradient is summed the same way (BatchNorm's statistics, the
    loss counts, the gradients and the metrics over the world; the
    disparity-sharded volume's exchanges over a disp subgroup);
    `all_reduce_(t, group)` is the in-place sum under it, which every
    all-reduce of the port goes through: it counts them (`ALL_REDUCES`)
    and their bytes (`ALL_REDUCE_BYTES`, utils/profiling.py::counters);
  * `new_subgroups(rows)` forms one subgroup per list of ranks, on every
    rank in the same order, and returns this rank's;
  * `process_index()` / `process_count()` are jax.process_index() /
    jax.process_count(): 0 and 1 without a process group.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence, Union

import torch
import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank_device(device: torch.device) -> torch.device:
    """With more than one process, a CUDA device becomes this rank's card,
    cuda:<rank % device_count>; anything else is returned as it is."""
    if device.type != "cuda" or process_count() == 1:
        return device
    dev = torch.device("cuda", process_index() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """Join the process group and return the device this process drives.

    The arguments default to the environment's `DCANET_*` variables. With no
    process count, one process, or a group already formed (by the caller,
    who then chose its backend), nothing is started. Otherwise the group is
    formed over `tcp://<coordinator>` with NCCL when `device` is CUDA and
    gloo when it is the CPU; a missing coordinator or process id, or a
    failure to form the group, raises. `device` (default
    CUDA) becomes cuda:<rank % device_count> when there is more than one
    process."""
    device = torch.device("cuda" if device is None else device)
    coordinator_address = coordinator_address or os.environ.get("DCANET_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("DCANET_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("DCANET_PROCESS_ID")
        process_id = int(env) if env else None
    if dist.is_initialized() or not num_processes or num_processes <= 1:
        return _rank_device(device)
    if not coordinator_address:
        raise ValueError(f"{num_processes} processes but no coordinator address (DCANET_COORDINATOR)")
    if process_id is None:
        raise ValueError(f"{num_processes} processes but no process id (DCANET_PROCESS_ID)")
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return _rank_device(device)


def sync_hosts() -> None:
    """Barrier across all processes; nothing with one process."""
    if process_count() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group on every rank: a barrier, so that no rank
    leaves while another still talks to it, then destroy the group. Nothing
    without a group."""
    if dist.is_available() and dist.is_initialized():
        sync_hosts()
        dist.destroy_process_group()


def group_size(group=None) -> int:
    """The ranks of `group` (the world for None); 1 without a process group."""
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def new_subgroups(rows: Iterable[Sequence[int]]):
    """One process group for each list of ranks in `rows`, formed on every
    rank in the same order (`dist.new_group` asks every rank to form every
    group); the group that holds this rank, None if none does."""
    mine, me = None, process_index()
    for ranks in rows:
        group = dist.new_group(ranks=list(ranks))
        if me in ranks:
            mine = group
    return mine


ALL_REDUCES = 0
ALL_REDUCE_BYTES = 0


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks of `group` in place, counted; returns `t`."""
    global ALL_REDUCES, ALL_REDUCE_BYTES
    ALL_REDUCES += 1
    ALL_REDUCE_BYTES += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; the gradient of a sum over the ranks
    is the sum of the ranks' gradients, over the same group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (the world for None), a new
    tensor, differentiable; `t` itself with one rank. Every rank of the
    group must call it in the same order."""
    return _AllReduceSum.apply(t, group) if group_size(group) > 1 else t
