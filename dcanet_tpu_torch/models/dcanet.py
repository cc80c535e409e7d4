"""DCANet eval forward (port of dcanet_tpu/models/dcanet.py:133-260).

Pipeline (reference models/gwcnet_dca_g.py:209-282): shared-weight 2D
features at 1/4 resolution -> 40-group gwc volume (the CUDA kernel on the
card) + 24-channel concat volume -> dres0/dres1 pre-aggregation -> chain of
CVA blocks (residual add after the first) -> classif head -> softmax over D
-> soft-argmin -> convex 4x upsample guided by the left image.

Submodule names reproduce the reference's state_dict keys, and the module
owns classif0..classif{num_cva} although eval runs only the last, so a full
reference or JAX checkpoint loads with `load_state_dict(strict=True)`.
Left and right run the shared extractor as one stacked batch (identical to
two calls in eval mode). Layouts: images (B, 3, H, W), disparity (B, H, W),
class logits (B, D', H', W').
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from dcanet_tpu_torch.kernels.gwc import gwc_volume
from dcanet_tpu_torch.nn.cva import CVA
from dcanet_tpu_torch.nn.feature import FeatureExtractor
from dcanet_tpu_torch.nn.guidance import Guidance
from dcanet_tpu_torch.nn.layers import ConvBN
from dcanet_tpu_torch.nn.propagation import PropagationNet
from dcanet_tpu_torch.ops.cost_volume import build_concat_volume
from dcanet_tpu_torch.ops.regression import disparity_regression


class DCANetEvalOutput(NamedTuple):
    disparity: torch.Tensor  # (B, H, W), float32
    class_logits: Tuple[torch.Tensor, ...]  # raw CVA logits (B, D/8, H/8, W/8)


def _classifier(c: int) -> nn.Sequential:
    """convbn_3d + relu, then a 3x3x3 conv to 1 channel of cost logits."""
    return nn.Sequential(ConvBN(c, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True), nn.Conv3d(c, 1, 3, 1, 1, bias=False))


class DCANet(nn.Module):
    def __init__(
        self, maxdisp: int = 192, num_cva: int = 3, num_groups: int = 40,
        concat_channels: int = 12, base_channels: int = 32,
    ):
        super().__init__()
        if maxdisp % 4:
            raise ValueError(f"maxdisp must be a multiple of 4, got {maxdisp}")
        self.maxdisp, self.num_cva, self.num_groups = maxdisp, num_cva, num_groups
        c = base_channels
        self.feature_extraction = FeatureExtractor(concat_channels)
        self.guidance = Guidance(64)
        self.dres0 = nn.Sequential(
            ConvBN(num_groups + 2 * concat_channels, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True),
            ConvBN(c, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True),
        )
        self.dres1 = nn.Sequential(
            ConvBN(c, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True), ConvBN(c, c, 3, 1, 1, dims=3)
        )
        for i in range(1, num_cva + 1):
            self.add_module(f"cva{i}", CVA(c))
        for i in range(num_cva + 1):
            self.add_module(f"classif{i}", _classifier(c))
        self.prop = PropagationNet(64, scale=4)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> DCANetEvalOutput:
        """left, right: (B, 3, H, W) with H, W multiples of 16."""
        if self.training:
            raise RuntimeError("the port's DCANet implements the eval forward only; call .eval() first")
        b = left.shape[0]
        d4 = self.maxdisp // 4
        feats = self.feature_extraction(torch.cat([left, right], dim=0))
        gwc, cat = feats["gwc_feature"], feats["concat_feature"]
        guidance = self.guidance(left)

        volume = gwc_volume(gwc[:b], gwc[b:], d4, self.num_groups)
        concat = build_concat_volume(cat[:b], cat[b:], d4)
        volume = torch.cat([volume, concat.to(volume.dtype)], dim=1)

        cost0 = self.dres0(volume)
        cost0 = self.dres1(cost0) + cost0

        out, cva_logits = cost0, []
        for i in range(1, self.num_cva + 1):
            logits, out = getattr(self, f"cva{i}")(out, post_residual=cost0 if i == 1 else None)
            cva_logits.append(logits)

        final_cost = getattr(self, f"classif{self.num_cva}")(out)[:, 0]
        # softmax and soft-argmin stay in float32, also under bf16 autocast
        with torch.autocast(device_type=final_cost.device.type, enabled=False):
            pred_coarse = disparity_regression(final_cost.float().softmax(dim=1), d4)
        disparity = self.prop(guidance, pred_coarse)
        return DCANetEvalOutput(disparity=disparity, class_logits=tuple(cva_logits))
