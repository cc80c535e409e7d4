"""The CVA block (the paper's DCA module) and SemanticLevelContext.

Port of dcanet_tpu/nn/cva.py, non-packed branch:
  - SemanticLevelContext (reference models/augment/semantic_level.py:15-128):
    dense `slc_pool`, then cross-attention with query = cost volume and
    key/value = pooled context + cost volume.
  - CVA (reference models/augment/cva.py:33-71): AvgPool3d(3, s2, p1) +
    convbn + relu downsample, a 3D-conv classify head giving 1-channel
    disparity-class logits, SLC injection, trilinear 2x upsample, 1x1x1 `fuse`
    of concat(augmented, input), and MultiAggregation.

Cost volumes are (B, C, D, H, W); classification logits (B, D, H, W).

With a `DispShard` (parallel/sharding.py) a CVA block runs on this rank's
planes of a D-sharded volume: the pool, the 3x3x3 convs, the resize and
MultiAggregation on halos (`nn/layers.py::run_sharded`), the class logits
gathered whole for the SLC pooling and returned whole, the attention's keys
over every plane.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dcanet_tpu_torch.nn.aggregation import MultiAggregation
from dcanet_tpu_torch.nn.attention import DisparityAttentionBlock
from dcanet_tpu_torch.nn.layers import ConvBN, avg_pool3d_torch, run_sharded
from dcanet_tpu_torch.ops.precision import at_least_f32, in_model_dtype
from dcanet_tpu_torch.ops.slc import slc_pool
from dcanet_tpu_torch.ops.upsample import resize_trilinear


class SemanticLevelContext(nn.Module):
    def __init__(self, feats_channels: int = 32, transform_channels: int = 32):
        super().__init__()
        self.cross_attention = DisparityAttentionBlock(feats_channels, transform_channels, feats_channels)

    def forward(self, x: torch.Tensor, logits: torch.Tensor, shard=None) -> torch.Tensor:
        """x: (B, C, D, H, W) cost volume; logits: (B, D, H, W) class logits
        (with a `shard`, x is this rank's planes and the logits are whole).
        The pooling computes in the model's dtype, its statistics in float32
        in training (ops/precision.py)."""
        widen = at_least_f32 if self.training else (lambda lg: lg)
        pooled = in_model_dtype(lambda v, lg: slc_pool(v, widen(lg), shard), x, logits)
        return self.cross_attention(x, pooled + x, shard)


class CVA(nn.Module):
    def __init__(self, channels: int = 32):
        super().__init__()
        c = channels
        self.downsample = nn.Sequential(avg_pool3d_torch(), ConvBN(c, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True))
        self.classify = nn.Sequential(
            ConvBN(c, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True),
            nn.Conv3d(c, 1, 3, 1, 1, bias=False),
        )
        self.slc_net = SemanticLevelContext(c, c)
        self.fuse = nn.Sequential(ConvBN(2 * c, c, 1, 1, 0, dims=3))
        self.cost_agg = MultiAggregation(c)

    def forward(
        self, cost_volume: torch.Tensor, post_residual: Optional[torch.Tensor] = None, shard=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (class_logits (B, D/2, H/2, W/2), aggregated cost
        (B, C, D, H, W)); D, H and W must be even. With a `shard` the volumes
        are this rank's planes and the logits whole."""
        cost_down = run_sharded(self.downsample, cost_volume, shard)
        logits = run_sharded(self.classify, cost_down, shard)[:, 0]
        if shard is not None:
            logits = shard.gather(logits, 1)
        context = self.slc_net(cost_down, logits, shard)
        augmented = in_model_dtype(lambda t: resize_trilinear(t, 2, shard), context)
        fused = self.fuse(torch.cat([augmented.to(cost_volume.dtype), cost_volume], dim=1))
        return logits, self.cost_agg(fused, post_residual, shard)
