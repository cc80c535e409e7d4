"""GANet-style stereo network (port of dcanet_tpu/models/ganet.py:54-128).

Pipeline: shared-weight 2D features of the stacked pair (1/4 resolution) ->
gwc volume (the CUDA kernels on the card) followed by the concat volume
(concat alone with `use_gwc_volume=False`) -> dres0/dres1 pre-aggregation
with its residual -> `num_sga` SGA blocks, each added to the cost (`cost +
agg`) -> an LGA block, added likewise -> classif_final -> softmax over D ->
soft-argmin -> convex 4x upsample guided by the left image.

  eval  -> DCANetEvalOutput(disparity, class_logits=())
  train -> DCANetTrainOutput(prob_volumes=(), disparities=aux + (final,),
           class_logits=()), one aux disparity per SGA stage from its head
           `classif_sga{i}` (cost upsampled 4x, softmax over all maxdisp
           disparities, soft-argmin). The aux heads exist in eval too and
           are not run there.

Softmax, soft-argmin and the SGA/LGA recurrences run in float32, also under
bf16 autocast. Module names are the port's own (the reference never
assembled GANet); `weights.ganet_table` maps them to the flax variables.
"""

from __future__ import annotations

import torch
from torch import nn

from dcanet_tpu_torch.models.dcanet import (
    DCANetEvalOutput, DCANetTrainOutput, _classifier, _pre_aggregation, _softmax_f32, _upsampled_disparity,
    cost_volume, stereo_features,
)
from dcanet_tpu_torch.nn.feature import FeatureExtractor
from dcanet_tpu_torch.nn.ganet import LGABlock, SGABlock
from dcanet_tpu_torch.nn.guidance import Guidance
from dcanet_tpu_torch.nn.propagation import PropagationNet
from dcanet_tpu_torch.ops.cost_volume import build_concat_volume
from dcanet_tpu_torch.ops.regression import disparity_regression


class GANetStereo(nn.Module):
    def __init__(
        self, maxdisp: int = 192, num_sga: int = 2, use_lga: bool = True, use_gwc_volume: bool = True,
        num_groups: int = 40, concat_channels: int = 12, base_channels: int = 32, sga_normalize: str = "softmax",
    ):
        super().__init__()
        if maxdisp % 4:
            raise ValueError(f"maxdisp must be a multiple of 4, got {maxdisp}")
        self.maxdisp, self.num_sga, self.use_lga = maxdisp, num_sga, use_lga
        self.use_gwc_volume, self.num_groups = use_gwc_volume, num_groups
        c = base_channels
        self.feature_extraction = FeatureExtractor(concat_channels)
        self.guidance = Guidance(64)
        in_channels = 2 * concat_channels + (num_groups if use_gwc_volume else 0)
        self.dres0, self.dres1 = _pre_aggregation(in_channels, c)
        for i in range(num_sga):
            self.add_module(f"sga{i}", SGABlock(64, normalize=sga_normalize))
            self.add_module(f"classif_sga{i}", _classifier(c))
        self.lga = LGABlock(64) if use_lga else None
        self.classif_final = _classifier(c)
        self.prop = PropagationNet(64, scale=4)

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        """left, right: (B, 3, H, W) with H, W multiples of 16."""
        d4 = self.maxdisp // 4
        feats_l, feats_r = stereo_features(self.feature_extraction, left, right)
        guidance = self.guidance(left)
        if self.use_gwc_volume:
            volume = cost_volume(feats_l, feats_r, d4, self.num_groups, use_concat=True)
        else:
            volume = build_concat_volume(feats_l["concat_feature"], feats_r["concat_feature"], d4)
        cost = self.dres0(volume)
        cost = self.dres1(cost) + cost

        aux = []
        for i in range(self.num_sga):
            cost = cost + getattr(self, f"sga{i}")(cost, guidance)
            if self.training:
                aux.append(_upsampled_disparity(getattr(self, f"classif_sga{i}")(cost)[:, 0], 4, self.maxdisp))
        if self.lga is not None:
            cost = cost + self.lga(cost, guidance)

        final_logits = self.classif_final(cost)[:, 0]
        with torch.autocast(device_type=final_logits.device.type, enabled=False):
            pred_coarse = disparity_regression(_softmax_f32(final_logits), d4)
        disparity = self.prop(guidance, pred_coarse)
        if not self.training:
            return DCANetEvalOutput(disparity=disparity, class_logits=())
        return DCANetTrainOutput(prob_volumes=(), disparities=tuple(aux) + (disparity,), class_logits=())
