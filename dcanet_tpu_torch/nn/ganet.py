"""GANet's guided aggregation blocks (port of dcanet_tpu/nn/ganet.py).

  * `my_normalize`: the reference's MyNormalize (signed L1).
  * SGABlock: a guidance subnet (convbn+relu, 3x3 conv to 4 x 5 taps) on
    image features at the cost's resolution, the taps normalised by softmax
    (default) or `my_normalize` ("l1"), then `ops.sga.sga_aggregate` over
    every channel of the (B, C, D, H, W) cost.
  * LGABlock: the same subnet predicting 3 x (2r+1)^2 filters, L1-normalised
    over all of them, then `ops.sga.lga3d`.

Module names are the port's own (no reference layout exists): `guide` is
Sequential(ConvBN, ReLU, Conv2d), keys `guide.0.0` / `guide.0.1` / `guide.2`.
"""

from __future__ import annotations

import torch
from torch import nn

from dcanet_tpu_torch.nn.layers import ConvBN
from dcanet_tpu_torch.ops.sga import lga3d, sga_aggregate


def my_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / sum(|x|) with a sign-following 1e-6 guard: norm + 1e-6 where the
    norm is positive, -1e-6 where it is zero (reference
    models/libs/GANet/modules/GANet.py:18-33, whose second in-place masked
    write reads the already modified tensor)."""
    norm = x.abs().sum(dim=dim, keepdim=True)
    return x / torch.where(norm > 0, norm + 1e-6, norm - 1e-6)


def _guide(in_channels: int, hidden: int, out_channels: int) -> nn.Sequential:
    return nn.Sequential(
        ConvBN(in_channels, hidden, 3, 1, 1), nn.ReLU(inplace=True),
        nn.Conv2d(hidden, out_channels, 3, 1, 1, bias=False),
    )


class SGABlock(nn.Module):
    def __init__(self, guidance_channels: int = 64, hidden: int = 32, normalize: str = "softmax"):
        super().__init__()
        if normalize not in ("softmax", "l1"):
            raise ValueError(f"normalize must be 'softmax' or 'l1', got {normalize!r}")
        self.normalize = normalize
        self.guide = _guide(guidance_channels, hidden, 4 * 5)

    def forward(self, cost: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        """cost: (B, C, D, H, W); guidance: (B, Cg, H, W). Returns (B, C, D, H, W)."""
        b, _, _, h, w = cost.shape
        logits = self.guide(guidance).view(b, 4, 5, h, w)
        with torch.autocast(device_type=cost.device.type, enabled=False):
            logits = logits.float()
            weights = my_normalize(logits, dim=2) if self.normalize == "l1" else logits.softmax(dim=2)
        return sga_aggregate(cost, weights)


class LGABlock(nn.Module):
    def __init__(self, guidance_channels: int = 64, hidden: int = 32, radius: int = 2):
        super().__init__()
        self.radius = radius
        self.guide = _guide(guidance_channels, hidden, 3 * (2 * radius + 1) ** 2)

    def forward(self, cost: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
        b, _, _, h, w = cost.shape
        filt = self.guide(guidance).view(b, 3, (2 * self.radius + 1) ** 2, h, w)
        with torch.autocast(device_type=cost.device.type, enabled=False):
            filt = filt.float()
            filt = filt / filt.abs().sum(dim=(1, 2), keepdim=True).clamp(min=1e-6)
        return lga3d(cost, filt, self.radius)
