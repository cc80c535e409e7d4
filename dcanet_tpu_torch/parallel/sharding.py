"""Disparity-axis (D) sharding of the cost volume, eval and training (port
of dcanet_tpu/parallel/sharding.py).

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
  * every exchange is one all-reduce of zero-filled per-rank slots over
    the mesh's disp subgroup (a row of a (data, disp) grid; the world where
    n_data = 1), in the tensor's dtype: exact (each element has one
    non-zero term), one code path for gloo on the CPU, gloo on one shared
    card (gloo takes CUDA tensors only in all_reduce and broadcast) and
    NCCL across cards, at n times the bytes of a point-to-point exchange;
  * the gradients are explicit: a gathered axis's gradient on a rank is its
    slice of the sum of the ranks' gradients (the all-reduce's own), and a
    halo plane's gradient goes back to the rank that sent it (`_Halo`, one
    all-reduce of slots in the backward); the edge ranks take part in
    every exchange, forward and backward, so that every rank reaches the
    collectives in one order.

In training every other sum runs over the world: BatchNorm's statistics
(on the sharded chain the whole volume's, on the 2D networks, which every
disp rank runs on the same rows, each sample n_disp times in the sum and
in the count: the same mean and variance), the loss denominators (each
disp rank's loss is 1/n_disp of its row's share) and the parameter
gradients (`train/loop.py`: a sharded layer's from each rank's planes, a
replicated one's 1/n_disp from each rank).

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

`DCANet` takes a plan in eval and in training (`cli eval
--n-disp-shards`, `cli train --n-disp-shards`); the other families refuse
one, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, List, Optional, Tuple

import torch

from dcanet_tpu_torch.parallel.distributed import all_reduce_, all_reduce_sum, group_size
from dcanet_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class DispShard:
    """This rank's share of a volume of `d` planes (1/4 resolution): the
    half planes [counts[:rank].sum(), ... + counts[rank]) of d/2, that is the
    planes `planes` of d. Every rank must call its exchanges in the same
    order, with slabs of the same shape but along D, in `group` (the disp
    ranks of its row of the grid; None: the world)."""

    n: int
    rank: int
    d: int
    counts: Tuple[int, ...]  # half planes per rank
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

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

    def _check_group(self) -> None:
        size = group_size(self.group)
        if size != self.n:
            raise RuntimeError(f"disp shard of {self.n} ranks in a group of {size} process(es)")

    def _exchange(self, slots: torch.Tensor) -> torch.Tensor:
        self._check_group()
        return all_reduce_sum(slots, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole D axis (`dim`) on every rank from each rank's slab;
        its gradient is this rank's slice of the ranks' gradients' sum."""
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
        self._check_group()
        return _Halo.apply(x, self, lo, hi, fill, dim)


class _Halo(torch.autograd.Function):
    """`DispShard.halo`. Forward: each rank puts its first `hi` and last `lo`
    planes in its slot, one all-reduce, and takes the rank below's last
    `lo` and the rank above's first `hi`. Backward: each rank puts the
    gradient of those halo planes in their sender's slot, one all-reduce,
    and adds what it finds in its own slot to its edge planes' gradients;
    an `"edge"` fill's copies give theirs to the edge plane they copy. Every
    rank, the edge ranks too, makes one exchange each way."""

    @staticmethod
    def forward(ctx, x, shard: DispShard, lo: int, hi: int, fill: str, dim: int):
        ctx.shard, ctx.lo, ctx.hi, ctx.fill, ctx.dim = shard, lo, hi, fill, dim
        m, r, n = x.shape[dim], shard.rank, shard.n
        slot = torch.cat([x.narrow(dim, 0, hi), x.narrow(dim, m - lo, lo)], dim)
        slots = x.new_zeros((n,) + tuple(slot.shape))
        slots[r] = slot
        all_reduce_(slots, shard.group)

        def end(edge: torch.Tensor, k: int) -> torch.Tensor:  # k planes beyond a volume end
            pad = edge.repeat_interleave(k, dim)
            return pad if fill == "edge" else torch.zeros_like(pad)

        below = slots[r - 1].narrow(dim, hi, lo) if r > 0 else end(x.narrow(dim, 0, 1), lo)
        above = slots[r + 1].narrow(dim, 0, hi) if r < n - 1 else end(x.narrow(dim, m - 1, 1), hi)
        return torch.cat([below, x, above], dim)

    @staticmethod
    def backward(ctx, grad):
        shard, lo, hi, fill, dim = ctx.shard, ctx.lo, ctx.hi, ctx.fill, ctx.dim
        r, n = shard.rank, shard.n
        m = grad.shape[dim] - lo - hi
        g_below, g_above = grad.narrow(dim, 0, lo), grad.narrow(dim, lo + m, hi)
        dx = grad.narrow(dim, lo, m).clone()
        shape = list(grad.shape)
        shape[dim] = hi + lo
        slots = grad.new_zeros([n] + shape)
        if r > 0:  # the planes below came from the rank below's last lo
            slots[r - 1].narrow(dim, hi, lo).copy_(g_below)
        if r < n - 1:  # the planes above from the rank above's first hi
            slots[r + 1].narrow(dim, 0, hi).copy_(g_above)
        all_reduce_(slots, shard.group)
        dx.narrow(dim, 0, hi).add_(slots[r].narrow(dim, 0, hi))
        dx.narrow(dim, m - lo, lo).add_(slots[r].narrow(dim, hi, lo))
        if fill == "edge" and r == 0:
            dx.narrow(dim, 0, 1).add_(g_below.sum(dim, keepdim=True))
        if fill == "edge" and r == n - 1:
            dx.narrow(dim, m - 1, 1).add_(g_above.sum(dim, keepdim=True))
        return dx, None, None, None, None, None


class DispPlan:
    """The disp axis of a mesh: `split(d)` is this rank's `DispShard` of a
    volume of d planes, or None where the volume stays replicated."""

    def __init__(self, n_disp: int, rank: int, group=None):
        if not 0 <= rank < n_disp:
            raise ValueError(f"disp rank {rank} outside [0, {n_disp})")
        self.n, self.rank, self.group = n_disp, rank, group

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
        return DispShard(n=self.n, rank=self.rank, d=d, counts=self.counts(d), group=self.group)


def make_disp_constraint(mesh: Mesh) -> DispPlan:
    """The plan that shards every DCANet volume's D axis over `mesh`'s disp
    axis, the exchanges within this rank's row of the grid."""
    return DispPlan(mesh.n_disp, mesh.disp_rank, mesh.disp_group)
