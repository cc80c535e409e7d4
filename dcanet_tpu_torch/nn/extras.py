"""Blocks of the reference's submodule.py that the flagship net does not use
(port of dcanet_tpu/nn/extras.py): FMish, pyramid pooling (PSP / ICNet),
the MobileV2 residual, the 2D hourglass and the UNet + PSP feature
extractor (models/feature_extraction.py:64-100). Layouts are NCHW; each
block takes its input channels at construction.

Module names are the reference's where it has the block (MobileV2_Residual's
`conv` Sequential, hourglass2d's conv1-6 / redir1-2), else the port's own;
`weights.py` maps them to the JAX package's flax paths.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from dcanet_tpu_torch.nn.layers import batch_norm, torch_conv_transpose2d


def fmish(x: torch.Tensor) -> torch.Tensor:
    """mish(x) = x * tanh(softplus(x)) (models/submodule.py:105-112)."""
    return x * torch.tanh(F.softplus(x))


def _resize_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear, half-pixel centres: jax.image.resize when it upsamples."""
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


class Conv2DBatchNormRelu(nn.Module):
    """conv (bias when `use_bias`) + optional BN + LeakyReLU(0.1)
    (models/submodule.py:16-38)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, use_bias: bool = True, with_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride, padding, dilation, bias=use_bias)
        self.bn = batch_norm(features, 2) if with_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return F.leaky_relu(y, 0.1)


class PyramidPooling(nn.Module):
    """PSP / ICNet pooling (models/submodule.py:41-102): per pool size ps, an
    average pool of kernel = stride = ps (floor geometry), a 1x1
    Conv2DBatchNormRelu and a bilinear resize back to (H, W). `cat` concatenates
    x and the C // n-channel paths; `sum` adds 0.25 of each C-channel path to x
    and returns fmish(sum / 2)."""

    def __init__(self, in_channels: int, pool_sizes: Sequence[int] = (32, 16, 8, 4), fusion_mode: str = "cat",
                 with_bn: bool = True):
        super().__init__()
        if fusion_mode not in ("cat", "sum"):
            raise ValueError(f"fusion_mode must be 'cat' or 'sum', got {fusion_mode!r}")
        self.pool_sizes = tuple(pool_sizes)
        self.fusion_mode = fusion_mode
        feats = in_channels // len(self.pool_sizes) if fusion_mode == "cat" else in_channels
        self.paths = nn.ModuleList(
            Conv2DBatchNormRelu(in_channels, feats, 1, 1, 0, use_bias=not with_bn, with_bn=with_bn)
            for _ in self.pool_sizes
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[2:]
        outs, acc = [x], x
        for ps, path in zip(self.pool_sizes, self.paths):
            y = _resize_to(path(F.avg_pool2d(x, ps, ps)), hw)
            if self.fusion_mode == "cat":
                outs.append(y)
            else:
                acc = acc + 0.25 * y
        if self.fusion_mode == "cat":
            return torch.cat(outs, dim=1)
        return fmish(acc / 2.0)


class MobileV2Residual(nn.Module):
    """Inverted residual (models/submodule.py:170-210): [1x1 expand + BN +
    ReLU6], depthwise 3x3 (groups = hidden) + BN + ReLU6, 1x1 project + BN;
    the input is added when stride is 1 and in_channels == features."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, expanse_ratio: int = 2, dilation: int = 1):
        super().__init__()
        hidden = in_channels * expanse_ratio
        self.use_res = stride == 1 and in_channels == features
        layers = []
        if expanse_ratio != 1:
            layers += [nn.Conv2d(in_channels, hidden, 1, bias=False), batch_norm(hidden, 2), nn.ReLU6(inplace=True)]
        layers += [
            nn.Conv2d(hidden, hidden, 3, stride, dilation, dilation, groups=hidden, bias=False),
            batch_norm(hidden, 2), nn.ReLU6(inplace=True),
            nn.Conv2d(hidden, features, 1, bias=False), batch_norm(features, 2),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


class Hourglass2D(nn.Module):
    """2D hourglass over MobileV2 residuals (models/submodule.py:213-248):
    (B, C, H, W) -> (B, C, H, W), H and W multiples of 4."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.conv1 = MobileV2Residual(c, c * 2, 2)
        self.conv2 = MobileV2Residual(c * 2, c * 2, 1)
        self.conv3 = MobileV2Residual(c * 2, c * 4, 2)
        self.conv4 = MobileV2Residual(c * 4, c * 4, 1)
        self.conv5 = nn.Sequential(torch_conv_transpose2d(c * 4, c * 2), batch_norm(c * 2, 2))
        self.conv6 = nn.Sequential(torch_conv_transpose2d(c * 2, c), batch_norm(c, 2))
        self.redir1 = MobileV2Residual(c, c, 1)
        self.redir2 = MobileV2Residual(c * 2, c * 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv2 = self.conv2(self.conv1(x))
        conv4 = self.conv4(self.conv3(conv2))
        conv5 = torch.relu(self.conv5(conv4) + self.redir2(conv2))
        return torch.relu(self.conv6(conv5) + self.redir1(x))


class UNetFeatureExtractor(nn.Module):
    """UNet-style extractor with pyramid pooling (models/feature_extraction.py):
    a stem to 1/2, stages to 1/4, 1/8 and 1/16, PSP at 1/16, two decoder
    stages with skip concats back to 1/4. Returns {"gwc_feature": (B,
    gwc_channels, H/4, W/4), "concat_feature": (B, concat_channels, H/4,
    W/4)}. Left and right go in stacked on the batch axis. H and W must be at
    least 128: PSP's 8x8 pool runs at 1/16."""

    def __init__(self, in_channels: int = 3, gwc_channels: int = 160, concat_channels: int = 12):
        super().__init__()
        cb = Conv2DBatchNormRelu
        self.stem = nn.Sequential(cb(in_channels, 32, 3, 2, 1), cb(32, 32, 3, 1, 1), cb(32, 32, 3, 1, 1))
        self.down4 = cb(32, 64, 3, 2, 1)
        self.down8 = cb(64, 128, 3, 2, 1)
        self.down16 = cb(128, 128, 3, 2, 1)
        self.psp = PyramidPooling(128, pool_sizes=(8, 4, 2, 1))
        self.psp_fuse = cb(128 + 4 * 32, 128, 1, 1, 0)
        self.dec8 = cb(128 + 128, 128, 3, 1, 1)
        self.dec4 = cb(128 + 64, gwc_channels, 3, 1, 1)
        self.lastconv = nn.Conv2d(gwc_channels, concat_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        l2 = self.down4(self.stem(x))
        l3 = self.down8(l2)
        l4 = self.psp_fuse(self.psp(self.down16(l3)))
        d8 = self.dec8(torch.cat([_resize_to(l4, l3.shape[2:]), l3], dim=1))
        d4 = self.dec4(torch.cat([_resize_to(d8, l2.shape[2:]), l2], dim=1))
        return {"gwc_feature": d4, "concat_feature": self.lastconv(d4)}
