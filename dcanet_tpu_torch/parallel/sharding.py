"""Disparity-axis (D) sharding of the cost volume for eval (port of
dcanet_tpu/parallel/sharding.py).

For full-resolution pairs (ETH3D at 768x1024, Middlebury at maxdisp 240) the
(B, C, D, H, W) volumes dominate a forward's memory, so their D axis is split
over the ranks of the mesh's `disp` axis. The JAX package pins D with a
sharding constraint and XLA inserts the halo exchanges of the 3x3x3 convs
and the reductions over D. Here each rank is a process, and the exchanges
are explicit:

  * `make_disp_constraint(mesh)` returns a `DispPlan`; `DCANet(...,
    constrain_volume=plan)` asks it for the rank's share of a volume of D
    planes (`plan.split(D)`), a `DispShard`, or None (replicated);
  * a rank builds, aggregates and holds only its contiguous planes of each
    volume; `DispShard.halo` pads its slab with the neighbours' edge planes
    (a 3x3x3 conv, the CVA's pool and transposed conv, the trilinear 2x),
    and `gather` gives every rank the whole D axis (the CVA's class logits
    and key features, the final cost);
  * every exchange is one `distributed.all_reduce_sum` of zero-filled
    per-rank slots, in the tensor's dtype: exact (each element has one
    non-zero term), one code path for gloo on the CPU, gloo on one shared
    card (gloo takes CUDA tensors only in all_reduce and broadcast) and
    NCCL across cards, at n times the bytes of a point-to-point exchange.

The unit of a shard is one plane of the CVA's half-resolution volume, a
pair of planes of the 1/4-resolution volume, so that every range starts on
an even plane, as the CVA's AvgPool3d(3, s2, p1) and MultiAggregation's
stride-2 conv need. The D/2 half planes are split into contiguous ranges,
as even as can be, the first (D/2 mod n) ranks taking one more: D = 60
(Middlebury, maxdisp 240) on 8 ranks gives 4,4,4,4,4,4,3,3 half planes.
Where D/2 < n, or D is odd, the plan warns, as `make_disp_constraint`
does, and every rank runs the unsharded forward with no collective. The
JAX package stays replicated only at D < n: the port replicates at D/2 < n
too, a difference in placement, not in results.

Eval only: a train-mode forward with a plan that shards raises (ROADMAP
Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import torch

from dcanet_tpu_torch.parallel.distributed import all_reduce_sum, process_count
from dcanet_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class DispShard:
    """This rank's share of a volume of `d` planes (1/4 resolution): the
    half planes [counts[:rank].sum(), ... + counts[rank]) of d/2, that is the
    planes `planes` of d. Every rank must call its exchanges in the same
    order, with slabs of the same shape but along D."""

    n: int
    rank: int
    d: int
    counts: Tuple[int, ...]  # half planes per rank

    @property
    def half_planes(self) -> Tuple[int, int]:
        lo = sum(self.counts[: self.rank])
        return lo, lo + self.counts[self.rank]

    @property
    def planes(self) -> Tuple[int, int]:
        lo, hi = self.half_planes
        return 2 * lo, 2 * hi

    def span(self, total: int) -> Tuple[int, int]:
        """This rank's range of an axis of `total` planes: `d` (1/4
        resolution) or d / 2 (the CVA's half resolution)."""
        sizes = self._sizes(total=total)
        lo = sum(sizes[: self.rank])
        return lo, lo + sizes[self.rank]

    def _sizes(self, total: Optional[int] = None, local: Optional[int] = None) -> List[int]:
        """Every rank's planes at the resolution of an axis of `total` planes,
        or of which this rank holds `local`."""
        for scale in (2, 1):
            if total == self.d // 2 * scale or local == self.counts[self.rank] * scale:
                return [c * scale for c in self.counts]
        raise ValueError(f"an axis of {total or local} planes is not of this plan's volume (D={self.d})")

    def _exchange(self, slots: torch.Tensor) -> torch.Tensor:
        if process_count() != self.n:
            raise RuntimeError(f"disp shard of {self.n} ranks in a group of {process_count()} process(es)")
        return all_reduce_sum(slots)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole D axis (`dim`) on every rank from each rank's slab."""
        sizes = self._sizes(local=x.shape[dim])
        shape = list(x.shape)
        shape[dim] = sum(sizes)
        full = x.new_zeros(shape)
        full.narrow(dim, sum(sizes[: self.rank]), x.shape[dim]).copy_(x)
        return self._exchange(full)

    def halo(self, x: torch.Tensor, lo: int, hi: int, fill: str = "zeros", dim: int = 2) -> torch.Tensor:
        """This rank's slab padded along `dim` with the `lo` planes below it
        (the rank below's last) and the `hi` above it (the rank above's
        first). At the volume's ends: zeros (`fill="zeros"`, a conv's
        padding) or copies of the edge plane (`"edge"`, a resize's clamp)."""
        if fill not in ("zeros", "edge"):
            raise ValueError(f"halo fill {fill!r}")
        m = x.shape[dim]
        if lo > m or hi > m:
            raise ValueError(f"a halo of {lo}/{hi} planes from slabs of {m}")
        slot = torch.cat([x.narrow(dim, 0, hi), x.narrow(dim, m - lo, lo)], dim)
        slots = x.new_zeros((self.n,) + tuple(slot.shape))
        slots[self.rank] = slot
        slots = self._exchange(slots)

        def end(edge: torch.Tensor, k: int) -> torch.Tensor:  # k planes beyond a volume end
            pad = edge.repeat_interleave(k, dim)
            return pad if fill == "edge" else torch.zeros_like(pad)

        below = slots[self.rank - 1].narrow(dim, hi, lo) if self.rank > 0 else end(x.narrow(dim, 0, 1), lo)
        above = slots[self.rank + 1].narrow(dim, 0, hi) if self.rank < self.n - 1 else end(x.narrow(dim, m - 1, 1), hi)
        return torch.cat([below, x, above], dim)


class DispPlan:
    """The disp axis of a mesh: `split(d)` is this rank's `DispShard` of a
    volume of d planes, or None where the volume stays replicated."""

    def __init__(self, n_disp: int, rank: int):
        if not 0 <= rank < n_disp:
            raise ValueError(f"disp rank {rank} outside [0, {n_disp})")
        self.n, self.rank = n_disp, rank

    def counts(self, d: int) -> Tuple[int, ...]:
        """Half planes per rank for a volume of d planes."""
        q, r = divmod(d // 2, self.n)
        return tuple(q + (1 if i < r else 0) for i in range(self.n))

    def split(self, d: int) -> Optional[DispShard]:
        if self.n == 1:
            return None
        if d % 2 or d // 2 < self.n:
            warnings.warn(
                f"disp-sharding skipped: volume D={d} gives {d // 2} pair(s) of planes"
                f"{' (D is odd)' if d % 2 else ''} for n_disp={self.n}; this volume stays replicated"
            )
            return None
        return DispShard(n=self.n, rank=self.rank, d=d, counts=self.counts(d))


def make_disp_constraint(mesh: Mesh) -> DispPlan:
    """The plan that shards every DCANet volume's D axis over `mesh`'s disp
    axis (eval; the data axis must be 1)."""
    if mesh.n_data != 1 and mesh.n_disp > 1:
        raise NotImplementedError(
            f"mesh data={mesh.n_data} disp={mesh.n_disp}: a (data, disp) grid is disparity-sharded training, "
            "ROADMAP Queue 1 item 4"
        )
    return DispPlan(mesh.n_disp, mesh.disp_rank)
