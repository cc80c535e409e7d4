"""Training losses: multi-scale smooth-L1 + stereo focal loss (port of
dcanet_tpu/losses.py:36-150; reference models/loss.py).

  * `model_loss`: weighted smooth-L1 over the disparity ladder, weights
    [1.8, 2.1] for two outputs, else the tail of the 7-level ladder; the
    masked mean is sum(loss*mask)/max(sum(mask), 1).
  * `stereo_focal_loss`: the gt rescaled to the volume's scale (average pool,
    max pool when sparse), masked to (start, maxdisp/scale) with strict
    inequalities, a Laplace gt probability volume, then
    -sum_d gtProb * log_softmax(est) * (1-gtProb)^(-alpha), masked and
    averaged over ALL pixels: masked pixels stay in the denominator.
  * `focal_loss_ladder`: weights [0.5, 0.7, 1.0, 1.2, 1.5] over the ladder.
    The model's volumes are already softmaxed and go into log_softmax as
    they are, as in the reference.
  * `ganet_loss`, `ganet_loss2`: GANet's robust losses with their
    hand-written backwards (dcanet_tpu/losses.py:169-222); no preset calls
    them.

Disparity maps are (B, H, W); probability volumes (B, D, H, W).

Under data parallelism (a process group of W ranks, equal shards) each
rank returns its share of the global batch's loss, so that the shares sum
to it: a masked mean divides by the global valid count (an all-reduce of
the rank's count), a plain mean by W.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dcanet_tpu_torch.ops.disp2prob import laplace_disp2prob
from dcanet_tpu_torch.parallel import distributed

SMOOTH_L1_WEIGHTS = (1.8, 2.1)
FOCAL_WEIGHTS = (0.5, 0.7, 1.0, 1.2, 1.5)
FULL_LADDER_WEIGHTS = (0.5, 0.7, 1.0, 1.2, 1.5, 1.8, 2.1)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (F.smooth_l1_loss semantics)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def masked_smooth_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean smooth-L1 over the masked pixels of the global batch."""
    m = mask.to(pred.dtype)
    return (smooth_l1(pred, target) * m).sum() / distributed.all_reduce_sum(m.sum()).clamp(min=1.0)


def model_loss(
    disp_ests: Sequence[torch.Tensor], disp_gt: torch.Tensor, mask: torch.Tensor,
    weights: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Weighted multi-scale smooth-L1 (reference models/loss.py:6-14)."""
    if weights is None:
        weights = SMOOTH_L1_WEIGHTS if len(disp_ests) == len(SMOOTH_L1_WEIGHTS) else FULL_LADDER_WEIGHTS[-len(disp_ests):]
    if len(weights) != len(disp_ests):
        raise ValueError(f"{len(weights)} weights for {len(disp_ests)} disparities")
    return sum(w * masked_smooth_l1(est, disp_gt, mask) for est, w in zip(disp_ests, weights))


def smoothness_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness (reference util.py:76-86):
    |dx disp| exp(-|dx img|) + |dy disp| exp(-|dy img|), averaged.
    disp: (B, H, W); img: (B, 3, H, W)."""
    dx_d = (disp[:, :, 1:] - disp[:, :, :-1]).abs()
    dy_d = (disp[:, 1:, :] - disp[:, :-1, :]).abs()
    dx_i = (img[..., 1:] - img[..., :-1]).abs().mean(dim=1)
    dy_i = (img[..., 1:, :] - img[..., :-1, :]).abs().mean(dim=1)
    return (dx_d * torch.exp(-dx_i)).mean() + (dy_d * torch.exp(-dy_i)).mean()


def _downsample_gt(gt: torch.Tensor, scale: int, sparse: bool) -> torch.Tensor:
    """adaptive_{avg,max}_pool2d for integer scales (loss.py:199-204, 215)."""
    b, h, w = gt.shape
    if h % scale or w % scale:
        raise ValueError(f"gt {tuple(gt.shape)} not divisible by scale {scale}")
    blocks = gt.reshape(b, h // scale, scale, w // scale, scale)
    return blocks.amax(dim=(2, 4)) if sparse else blocks.mean(dim=(2, 4))


def stereo_focal_loss(
    est_volume: torch.Tensor, disp_gt: torch.Tensor, max_disp: int = 192, focal_coefficient: float = 5.0,
    sparse: bool = False, variance: float = 1.0, start_disp: int = 0,
) -> torch.Tensor:
    """Single-level stereo focal loss (models/loss.py:206-240). est_volume:
    (B, D, h, w) at any scale; disp_gt: (B, H, W) at full resolution."""
    _, _, h, w = est_volume.shape
    gt = disp_gt
    scale = disp_gt.shape[-1] // w
    if disp_gt.shape[-2] != h or disp_gt.shape[-1] != w:
        gt = _downsample_gt(disp_gt / float(scale), scale, sparse)
        scale_f = float(scale)
    else:
        scale_f = 1.0
    lower = start_disp
    upper = lower + int(max_disp / scale_f)
    maskf = ((gt > lower) & (gt < upper)).to(est_volume.dtype)
    gt_prob = laplace_disp2prob(gt * maskf, int(max_disp / scale_f), variance=variance, start_disp=start_disp)
    est_logp = est_volume.log_softmax(dim=1)
    weight = (1.0 - gt_prob) ** (-focal_coefficient)
    per_pixel = -(gt_prob * est_logp * weight).sum(dim=1) * maskf
    return per_pixel.mean() / distributed.process_count()


def focal_loss_ladder(
    prob_volumes: Sequence[torch.Tensor], disp_gt: torch.Tensor, max_disp: int = 192,
    focal_coefficient: float = 5.0, sparse: bool = False, weights: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Weighted focal loss over the probability ladder (models/loss.py:16-24)."""
    if weights is None:
        weights = FOCAL_WEIGHTS[: len(prob_volumes)]
    if len(weights) != len(prob_volumes):
        raise ValueError(f"{len(weights)} weights for {len(prob_volumes)} volumes")
    return sum(
        w * stereo_focal_loss(vol, disp_gt, max_disp, focal_coefficient, sparse)
        for vol, w in zip(prob_volumes, weights)
    )


# GANet's custom robust losses (reference models/libs/GANet/functions/
# GANet.py:264-310). Their backward is not the forward's analytic gradient
# and keeps the reference's quirks: MyLoss2's backward rewrites |d| in
# sequence on the already rewritten values, and MyLoss's backward omits the
# forward mean's 1/N.


class _GANetLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, upper: float, lower: float):
        diff = pred - target
        ctx.save_for_backward(diff)
        ctx.upper, ctx.lower = upper, lower
        return diff.abs().mean()

    @staticmethod
    def backward(ctx, g):
        (diff,) = ctx.saved_tensors
        upper, lower = ctx.upper, ctx.lower
        s = diff.abs()
        s = torch.where(s > upper, torch.ones_like(s), s)
        tag = (s <= upper) & (s >= lower)
        s = torch.where(tag, 2.0 - (s - (upper + lower) / 2.0).abs() / 2.0, s)
        d = diff.sign() * s * g
        return d, -d, None, None


class _GANetLoss2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, thresh: float, alpha: float):
        diff = pred - target
        ctx.save_for_backward(diff)
        ctx.thresh, ctx.alpha = thresh, alpha
        t = diff.abs()
        s = torch.where(t < thresh, t * t / thresh, t)
        tag = (s <= thresh + alpha) & (s >= thresh)
        s = torch.where(tag, s * 2.0 - (s - thresh) ** 2 / (2.0 * alpha) - thresh, s)
        s = torch.where(s > thresh + alpha, s + alpha / 2.0, s)
        return s.mean()

    @staticmethod
    def backward(ctx, g):
        (diff,) = ctx.saved_tensors
        thresh, alpha = ctx.thresh, ctx.alpha
        s = diff.abs()
        s = torch.where(s > thresh + alpha, torch.ones_like(s), s)
        tag = (s <= thresh + alpha) & (s >= thresh)
        s = torch.where(tag, 2.0 - (s - thresh) / alpha, s)
        s = torch.where(s < thresh, 2.0 * s / thresh, s)
        d = diff.sign() * s * g / diff.numel()
        return d, -d, None, None


def ganet_loss(pred: torch.Tensor, target: torch.Tensor, upper: float = 5.0, lower: float = 1.0) -> torch.Tensor:
    """MyLossFunction: mean |pred - target|, with GANet's graduated backward."""
    return _GANetLoss.apply(pred, target, upper, lower)


def ganet_loss2(pred: torch.Tensor, target: torch.Tensor, thresh: float = 1.0, alpha: float = 2.0) -> torch.Tensor:
    """MyLoss2Function: a piecewise quadratic / linear robust loss whose
    three rewrites apply in sequence to the mutated values."""
    return _GANetLoss2.apply(pred, target, thresh, alpha)
