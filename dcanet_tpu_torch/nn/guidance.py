"""Guidance network for convex upsampling (port of dcanet_tpu/nn/guidance.py).

Reference Guidance (models/submodule.py:395-460), batch-norm flavour: 7x7/s2
conv stem, two ResidualBlock stages (32/s1, 64/s2) to 1/4 resolution, two
BasicConv 3x3, a final 3x3 conv to `output_dim` channels. NCHW in and out.
"""

from __future__ import annotations

import torch
from torch import nn

from dcanet_tpu_torch.nn.layers import BasicConv, ResidualBlock, batch_norm


class Guidance(nn.Module):
    def __init__(self, output_dim: int = 64):
        super().__init__()
        self.conv_start = nn.Sequential(nn.Conv2d(3, 32, 7, 2, 3))
        self.norm1 = batch_norm(32, 2)
        self.layer1 = nn.Sequential(ResidualBlock(32, 32, 1), ResidualBlock(32, 32, 1))
        self.layer2 = nn.Sequential(ResidualBlock(32, 64, 2), ResidualBlock(64, 64, 1))
        self.conv_g0 = nn.Sequential(BasicConv(64, 64, 3, 1, 1), BasicConv(64, 64, 3, 1, 1))
        self.guidance = nn.Conv2d(64, output_dim, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) -> (B, output_dim, H/4, W/4)."""
        x = torch.relu(self.norm1(self.conv_start(x)))
        x = self.conv_g0(self.layer2(self.layer1(x)))
        return self.guidance(x)
