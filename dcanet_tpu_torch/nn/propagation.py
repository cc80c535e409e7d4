"""Convex-upsampling mask head (port of dcanet_tpu/nn/propagation.py).

Reference PropgationNet_4x (models/submodule.py:357-392): convbn+relu then a
3x3 conv predicting 9*scale^2 blend logits, combined with the coarse
disparity by `ops.convex_upsample`.
"""

from __future__ import annotations

import torch
from torch import nn

from dcanet_tpu_torch.nn.layers import ConvBN
from dcanet_tpu_torch.ops.precision import in_model_dtype
from dcanet_tpu_torch.ops.upsample import convex_upsample


class PropagationNet(nn.Module):
    def __init__(self, base_channels: int = 64, scale: int = 4):
        super().__init__()
        self.scale = scale
        self.conv = nn.Sequential(
            ConvBN(base_channels, base_channels * 2, 3, 1, 1), nn.ReLU(inplace=True),
            nn.Conv2d(base_channels * 2, 9 * scale * scale, 3, 1, 1, bias=False),
        )

    def forward(self, guidance: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
        """guidance: (B, base_channels, H, W); disp: (B, H, W) coarse.
        Returns (B, H*scale, W*scale). The blend runs in float32 with
        autocast off, also in a bf16 model: a bf16 disparity above 128 would
        round to whole pixels (ops/precision.py, rule (a))."""
        mask_logits = self.conv(guidance)
        return in_model_dtype(lambda d, m: convex_upsample(d, m, self.scale), disp, mask_logits,
                              at_least=torch.float32)
