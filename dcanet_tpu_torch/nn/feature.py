"""Shared-weight 2D feature extractor (port of dcanet_tpu/nn/feature.py).

Reference feature_extraction (models/gwcnet_dca_g.py:13-66): a 3-conv
stride-2 stem, BasicBlock stages [3, 16, 3, 3] (stage 2 stride 2, stage 4
dilation 2), gwc feature = concat(l2, l3, l4) = 320 channels at 1/4
resolution, and a 12-channel concat feature head (`concat_feature=False`
drops it, as the gwc-only models do). NCHW in and out.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dcanet_tpu_torch.nn.layers import BasicBlock, ConvBN


def _layer(in_planes: int, planes: int, blocks: int, stride: int = 1, dilation: int = 1) -> nn.Sequential:
    layers = [BasicBlock(in_planes, planes, stride, dilation)]
    layers += [BasicBlock(planes, planes, 1, dilation) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


class FeatureExtractor(nn.Module):
    def __init__(self, concat_feature_channel: int = 12, concat_feature: bool = True):
        super().__init__()
        self.firstconv = nn.Sequential(
            ConvBN(3, 32, 3, 2, 1), nn.ReLU(inplace=True),
            ConvBN(32, 32, 3, 1, 1), nn.ReLU(inplace=True),
            ConvBN(32, 32, 3, 1, 1), nn.ReLU(inplace=True),
        )
        self.layer1 = _layer(32, 32, 3)
        self.layer2 = _layer(32, 64, 16, stride=2)
        self.layer3 = _layer(64, 128, 3)
        self.layer4 = _layer(128, 128, 3, dilation=2)
        self.lastconv = None
        if concat_feature:
            self.lastconv = nn.Sequential(
                ConvBN(320, 128, 3, 1, 1), nn.ReLU(inplace=True),
                nn.Conv2d(128, concat_feature_channel, 1, bias=False),
            )

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B, 3, H, W) -> {"gwc_feature": (B, 320, H/4, W/4),
        "concat_feature": (B, 12, H/4, W/4)}, the latter only with the
        concat head."""
        x = self.layer1(self.firstconv(x))
        l2 = self.layer2(x)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        gwc_feature = torch.cat([l2, l3, l4], dim=1)
        if self.lastconv is None:
            return {"gwc_feature": gwc_feature}
        return {"gwc_feature": gwc_feature, "concat_feature": self.lastconv(gwc_feature)}
