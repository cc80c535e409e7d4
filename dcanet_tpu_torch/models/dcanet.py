"""DCANet and the plain GwcNet baseline, eval and train forwards (port of
dcanet_tpu/models/dcanet.py:133-386).

DCANet pipeline (reference models/gwcnet_dca_g.py:209-282): shared-weight 2D
features at 1/4 resolution -> 40-group gwc volume (the CUDA kernels on the
card, forward and backward) + 24-channel concat volume (none with
`use_concat_volume=False`, the registry's `dcanet-g`) -> dres0/dres1
pre-aggregation -> chain of CVA blocks (residual add after the first) ->
classif head -> softmax over D -> soft-argmin -> convex 4x upsample guided by
the left image.

  eval  -> DCANetEvalOutput(disparity, class_logits)
  train -> DCANetTrainOutput(prob_volumes, disparities, class_logits), the
           JAX package's supervision contract:
    * prob_volumes (stereo-focal ladder, softmaxed, 1/4 resolution):
      [softmax(classif0(cost0))] + [softmax(up2(cva_i logits)), i < num_cva]
      + [softmax(classif_i(out_i)), 1 <= i < num_cva], i.e.
      [pred0, pred_dca1, pred_dca2, pred1, pred2] for num_cva=3; for
      num_cva=0 the final head's probabilities alone;
    * disparities (smooth-L1 ladder, full resolution): [soft-argmin of
      up8(last CVA logits), the convex-upsampled final];
    * full_res_supervision: every CVA's logits (x8) and classif_i(out_i)
      (x4) soft-argmin'd at full resolution, then the final: 2*num_cva+1
      disparities and no focal ladder.

Submodule names reproduce the reference's state_dict keys, and the module
owns classif0..classif{num_cva}, so a full reference or JAX checkpoint loads
with `load_state_dict(strict=True)`. `stacked_features` (default True, as in
the JAX package) runs left and right through the shared extractor as one
stacked batch, so train-mode BatchNorm takes its statistics over the pair;
False runs two calls. `remat` checkpoints each CVA block in train mode
(torch.utils.checkpoint); the recomputation leaves the BatchNorm running
statistics alone, as flax's nn.remat does. Softmax and soft-argmin run in
float32, also under bf16 autocast. Layouts: images (B, 3, H, W), disparity
(B, H, W), probability volumes (B, D/4, H/4, W/4), class logits
(B, D/8, H/8, W/8).

`constrain_volume` (the JAX field's name) takes the plan of
`parallel.make_disp_constraint(mesh)`: in eval and in training, each rank
of the mesh's disp axis builds (the gwc kernel's plane range), aggregates
and holds only its planes of every volume, the 3x3x3 chain and the
classif heads on halos; the CVA's class logits and every head's cost are
gathered whole, so that the softmax, soft-argmin, `prop` and the losses
run replicated and every rank returns the unsharded forward's result. In
training the backward's exchanges mirror the forward's (parallel/
sharding.py), the gwc volume's backward is the plane range's, and with
`remat` each CVA block's recomputation repeats its exchanges.

GwcNetBaseline (reference models/gwcnet.py:107-249): the same features and
volumes, dres0/dres1, three stacked Hourglass3D aggregators (dres2-4) and
four classif heads, each cost upsampled 4x trilinearly to full resolution,
softmaxed over all maxdisp disparities and soft-argmin'd; no guidance, no
CVA, no class logits.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dcanet_tpu_torch.kernels.gwc import gwc_volume
from dcanet_tpu_torch.nn.aggregation import Hourglass3D
from dcanet_tpu_torch.nn.cva import CVA
from dcanet_tpu_torch.nn.feature import FeatureExtractor
from dcanet_tpu_torch.nn.guidance import Guidance
from dcanet_tpu_torch.nn.layers import ConvBN, frozen_bn_statistics, run_sharded
from dcanet_tpu_torch.nn.propagation import PropagationNet
from dcanet_tpu_torch.ops.cost_volume import build_concat_volume
from dcanet_tpu_torch.ops.precision import at_least_f32
from dcanet_tpu_torch.ops.regression import disparity_regression
from dcanet_tpu_torch.ops.upsample import resize_trilinear


class DCANetEvalOutput(NamedTuple):
    disparity: torch.Tensor  # (B, H, W), float32
    class_logits: Tuple[torch.Tensor, ...]  # raw CVA logits (B, D/8, H/8, W/8)


class DCANetTrainOutput(NamedTuple):
    prob_volumes: Tuple[torch.Tensor, ...]  # (B, D/4, H/4, W/4) softmax probabilities, float32
    disparities: Tuple[torch.Tensor, ...]  # (B, H, W) full-resolution estimates, float32
    class_logits: Tuple[torch.Tensor, ...]  # raw CVA logits (B, D/8, H/8, W/8)


def _classifier(c: int) -> nn.Sequential:
    """convbn_3d + relu, then a 3x3x3 conv to 1 channel of cost logits."""
    return nn.Sequential(ConvBN(c, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True), nn.Conv3d(c, 1, 3, 1, 1, bias=False))


def _remat_contexts():
    """torch.utils.checkpoint's (forward, recomputation) contexts."""
    return contextlib.nullcontext(), frozen_bn_statistics()


def _softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    return at_least_f32(logits).softmax(dim=1)


def _upsampled_disparity(logits: torch.Tensor, scale: int, maxdisp: int) -> torch.Tensor:
    """Soft-argmin of the softmax over D of `logits` upsampled `scale`x
    trilinearly, in float32 also under autocast: (B, D, h, w) -> (B, H, W)."""
    with torch.autocast(device_type=logits.device.type, enabled=False):
        return disparity_regression(_softmax_f32(resize_trilinear(at_least_f32(logits), scale)), maxdisp)


def _pre_aggregation(in_channels: int, c: int) -> Tuple[nn.Sequential, nn.Sequential]:
    """dres0 (2x convbn3d+relu) and dres1 (convbn3d+relu, convbn3d), whose
    output the caller adds to dres0's."""
    dres0 = nn.Sequential(
        ConvBN(in_channels, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True),
        ConvBN(c, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True),
    )
    dres1 = nn.Sequential(ConvBN(c, c, 3, 1, 1, dims=3), nn.ReLU(inplace=True), ConvBN(c, c, 3, 1, 1, dims=3))
    return dres0, dres1


def stereo_features(extractor: nn.Module, left: torch.Tensor, right: torch.Tensor, stacked: bool = True):
    """The shared extractor's (left, right) feature dicts: one stacked batch,
    or two calls (per-image train-mode BatchNorm statistics)."""
    if stacked:
        b = left.shape[0]
        feats = extractor(torch.cat([left, right], dim=0))
        return ({k: v[:b] for k, v in feats.items()}, {k: v[b:] for k, v in feats.items()})
    return extractor(left), extractor(right)


def cost_volume(feats_l, feats_r, d4: int, num_groups: int, use_concat: bool,
                planes: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The gwc volume (the CUDA kernel on the card), followed on the channel
    axis by the concat volume when `use_concat`: (B, G [+ 2*C], D/4, H/4, W/4),
    or its planes [d_lo, d_hi) with `planes`."""
    volume = gwc_volume(feats_l["gwc_feature"], feats_r["gwc_feature"], d4, num_groups, planes)
    if not use_concat:
        return volume
    concat = build_concat_volume(feats_l["concat_feature"], feats_r["concat_feature"], d4, planes)
    return torch.cat([volume, concat.to(volume.dtype)], dim=1)


class DCANet(nn.Module):
    def __init__(
        self, maxdisp: int = 192, num_cva: int = 3, use_concat_volume: bool = True, num_groups: int = 40,
        concat_channels: int = 12, base_channels: int = 32,
        full_res_supervision: bool = False, stacked_features: bool = True, remat: bool = False,
        constrain_volume=None,
    ):
        super().__init__()
        if maxdisp % 4:
            raise ValueError(f"maxdisp must be a multiple of 4, got {maxdisp}")
        self.maxdisp, self.num_cva, self.num_groups = maxdisp, num_cva, num_groups
        self.constrain_volume = constrain_volume
        self.use_concat_volume = use_concat_volume
        self.full_res_supervision, self.stacked_features, self.remat = full_res_supervision, stacked_features, remat
        c = base_channels
        self.feature_extraction = FeatureExtractor(concat_channels, concat_feature=use_concat_volume)
        self.guidance = Guidance(64)
        self.dres0, self.dres1 = _pre_aggregation(num_groups + (2 * concat_channels if use_concat_volume else 0), c)
        for i in range(1, num_cva + 1):
            self.add_module(f"cva{i}", CVA(c))
        for i in range(num_cva + 1):
            self.add_module(f"classif{i}", _classifier(c))
        self.prop = PropagationNet(64, scale=4)

    def _cva(self, i: int, x: torch.Tensor, post_residual, shard=None):
        block = getattr(self, f"cva{i}")
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, x, post_residual, shard, use_reentrant=False, context_fn=_remat_contexts)
        return block(x, post_residual, shard)

    def _head(self, i: int, x: torch.Tensor, shard=None) -> torch.Tensor:
        cost = run_sharded(getattr(self, f"classif{i}"), x, shard)[:, 0]
        return cost if shard is None else shard.gather(cost, 1)

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        """left, right: (B, 3, H, W) with H, W multiples of 16."""
        d4 = self.maxdisp // 4
        shard = None if self.constrain_volume is None else self.constrain_volume.split(d4)
        feats_l, feats_r = stereo_features(self.feature_extraction, left, right, self.stacked_features)
        guidance = self.guidance(left)
        volume = cost_volume(feats_l, feats_r, d4, self.num_groups, self.use_concat_volume,
                             None if shard is None else shard.planes)

        cost0 = run_sharded(self.dres0, volume, shard)
        cost0 = run_sharded(self.dres1, cost0, shard) + cost0

        out, outs, cva_logits = cost0, [cost0], []
        for i in range(1, self.num_cva + 1):
            logits, out = self._cva(i, out, cost0 if i == 1 else None, shard)
            cva_logits.append(logits)
            outs.append(out)

        final_cost = self._head(self.num_cva, out, shard)
        with torch.autocast(device_type=final_cost.device.type, enabled=False):
            final_prob = _softmax_f32(final_cost)
            pred_coarse = disparity_regression(final_prob, d4)
        disparity = self.prop(guidance, pred_coarse)
        if not self.training:
            return DCANetEvalOutput(disparity=disparity, class_logits=tuple(cva_logits))

        heads = {i: self._head(i, outs[i], shard) for i in range(self.num_cva)}
        with torch.autocast(device_type=final_cost.device.type, enabled=False):
            if self.full_res_supervision:
                disparities = [_upsampled_disparity(lg, 8, self.maxdisp) for lg in cva_logits]
                disparities += [_upsampled_disparity(heads[i], 4, self.maxdisp) for i in range(self.num_cva)]
                return DCANetTrainOutput(
                    prob_volumes=(), disparities=tuple(disparities) + (disparity,), class_logits=tuple(cva_logits)
                )
            if self.num_cva == 0:
                return DCANetTrainOutput(prob_volumes=(final_prob,), disparities=(disparity,), class_logits=())
            prob_volumes = [_softmax_f32(heads[0])]
            prob_volumes += [_softmax_f32(resize_trilinear(at_least_f32(lg), 2))
                             for lg in cva_logits[: self.num_cva - 1]]
            prob_volumes += [_softmax_f32(heads[i]) for i in range(1, self.num_cva)]
            disparities = (_upsampled_disparity(cva_logits[-1], 8, self.maxdisp), disparity)
        return DCANetTrainOutput(
            prob_volumes=tuple(prob_volumes), disparities=disparities, class_logits=tuple(cva_logits)
        )


class GwcNetBaseline(nn.Module):
    """Plain GwcNet (dcanet_tpu/models/dcanet.py:316-386).

      eval  -> DCANetEvalOutput(disparity=pred3, class_logits=())
      train -> DCANetTrainOutput(prob_volumes=(), disparities=(pred0, pred1,
               pred2, pred3), class_logits=())
    """

    def __init__(
        self, maxdisp: int = 192, use_concat_volume: bool = True, num_groups: int = 40,
        concat_channels: int = 12, stacked_features: bool = True,
    ):
        super().__init__()
        if maxdisp % 4:
            raise ValueError(f"maxdisp must be a multiple of 4, got {maxdisp}")
        self.maxdisp, self.use_concat_volume, self.num_groups = maxdisp, use_concat_volume, num_groups
        self.stacked_features = stacked_features
        c = 32
        self.feature_extraction = FeatureExtractor(concat_channels, concat_feature=use_concat_volume)
        self.dres0, self.dres1 = _pre_aggregation(num_groups + (2 * concat_channels if use_concat_volume else 0), c)
        self.dres2, self.dres3, self.dres4 = Hourglass3D(c), Hourglass3D(c), Hourglass3D(c)
        for i in range(4):
            self.add_module(f"classif{i}", _classifier(c))

    def _head(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return _upsampled_disparity(getattr(self, f"classif{i}")(x)[:, 0], 4, self.maxdisp)

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        """left, right: (B, 3, H, W) with H, W multiples of 16."""
        feats_l, feats_r = stereo_features(self.feature_extraction, left, right, self.stacked_features)
        volume = cost_volume(feats_l, feats_r, self.maxdisp // 4, self.num_groups, self.use_concat_volume)
        cost0 = self.dres0(volume)
        cost0 = self.dres1(cost0) + cost0
        out1 = self.dres2(cost0)
        out2 = self.dres3(out1)
        out3 = self.dres4(out2)
        pred3 = self._head(3, out3)
        if not self.training:
            return DCANetEvalOutput(disparity=pred3, class_logits=())
        preds = tuple(self._head(i, x) for i, x in enumerate((cost0, out1, out2)))
        return DCANetTrainOutput(prob_volumes=(), disparities=preds + (pred3,), class_logits=())
