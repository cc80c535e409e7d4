"""3D cost aggregation (port of dcanet_tpu/nn/aggregation.py, plain branch).

MultiAggregation: the CVA's shallow one-level 3D hourglass (reference
models/augment/cva.py:13-31). Hourglass3D: plain GwcNet's two-level 3D
hourglass (reference models/gwcnet.py:67-104). Volumes are (B, C, D, H, W).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dcanet_tpu_torch.nn.layers import (
    ConvBN, ConvBNAct, ConvBNSequential, batch_norm, run_sharded, torch_conv_transpose3d,
)


class MultiAggregation(nn.Module):
    """conv(s2) -> conv -> deconv(2x)+BN (folded in a bf16 eval, as the JAX
    `_deconv_bn`), residual 1x1x1 redir, relu, then the optional
    `post_residual` (the model-level `cost0 + agg`). With a
    `DispShard` (parallel/sharding.py) on this rank's planes: conv1, conv2
    and the deconv on halos, redir plane-local."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv1 = ConvBNAct(c, 2 * c, 3, 2, 1, dims=3)
        self.conv2 = ConvBNAct(2 * c, 2 * c, 3, 1, 1, dims=3)
        self.conv3 = ConvBNSequential(torch_conv_transpose3d(2 * c, c), batch_norm(c, 3))
        self.redir = ConvBN(c, c, 1, 1, 0, dims=3)

    def forward(self, x: torch.Tensor, post_residual: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
        y = x
        for conv in (self.conv1, self.conv2, self.conv3):
            y = run_sharded(conv, y, shard)
        out = torch.relu(y + self.redir(x))
        return out if post_residual is None else out + post_residual


class Hourglass3D(nn.Module):
    """conv1-conv4 (stride 2/1/2/1, 2c/2c/4c/4c), then two 2x deconvs with BN,
    each added to a 1x1x1 redir skip and ReLU'd (dcanet_tpu/nn/aggregation.py:
    164-190). Keys are the reference's: the deconv's BN is `conv5.1`."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv1 = ConvBNAct(c, 2 * c, 3, 2, 1, dims=3)
        self.conv2 = ConvBNAct(2 * c, 2 * c, 3, 1, 1, dims=3)
        self.conv3 = ConvBNAct(2 * c, 4 * c, 3, 2, 1, dims=3)
        self.conv4 = ConvBNAct(4 * c, 4 * c, 3, 1, 1, dims=3)
        self.conv5 = ConvBNSequential(torch_conv_transpose3d(4 * c, 2 * c), batch_norm(2 * c, 3))
        self.conv6 = ConvBNSequential(torch_conv_transpose3d(2 * c, c), batch_norm(c, 3))
        self.redir1 = ConvBN(c, c, 1, 1, 0, dims=3)
        self.redir2 = ConvBN(2 * c, 2 * c, 1, 1, 0, dims=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv2 = self.conv2(self.conv1(x))
        conv5 = torch.relu(self.conv5(self.conv4(self.conv3(conv2))) + self.redir2(conv2))
        return torch.relu(self.conv6(conv5) + self.redir1(x))
