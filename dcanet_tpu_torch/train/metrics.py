"""Stereo metrics (port of dcanet_tpu/train/metrics.py; reference
utils/metrics.py, util.py:55-74 and main_dca.py:66-120, 209-215).

Two ways to aggregate EPE, D1 and >1/2/3 px over a batch (B, H, W), as in
the reference:
  * `eval_metrics`: global masked means over the batch (the training loop's);
  * `per_image_metrics`: the eval protocol (utils/metrics.py:22-41), masked
    means per image, images whose mask covers under a tenth of their gt > 0
    pixels skipped, the rest averaged; `cli eval` uses it.
`disparity_class_confusion` and `segmentation_scores` score the DCA
module's disparity classes (PA, mPA, mIoU, FWIoU) from the CVA logits.
"""

from __future__ import annotations

from typing import Dict

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def epe_metric(disp_est: torch.Tensor, disp_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean absolute disparity error over masked pixels."""
    return _masked_mean((disp_est - disp_gt).abs(), mask)


def d1_metric(disp_est: torch.Tensor, disp_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """D1: error > 3 px and > 5 % of |gt|, as a rate over masked pixels."""
    err = (disp_est - disp_gt).abs()
    return _masked_mean(((err > 3.0) & (err > 0.05 * disp_gt.abs())).to(disp_est.dtype), mask)


def thres_metric(disp_est: torch.Tensor, disp_gt: torch.Tensor, mask: torch.Tensor, thres: float) -> torch.Tensor:
    """Fraction of masked pixels with error > thres."""
    return _masked_mean(((disp_est - disp_gt).abs() > thres).to(disp_est.dtype), mask)


def eval_metrics(disp_est: torch.Tensor, disp_gt: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """EPE, D1 and >1/2/3 px."""
    return {
        "epe": epe_metric(disp_est, disp_gt, mask),
        "d1": d1_metric(disp_est, disp_gt, mask),
        "thres1": thres_metric(disp_est, disp_gt, mask, 1.0),
        "thres2": thres_metric(disp_est, disp_gt, mask, 2.0),
        "thres3": thres_metric(disp_est, disp_gt, mask, 3.0),
    }


def per_image_metrics(disp_est: torch.Tensor, disp_gt: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-image masked means, averaged over the images kept (0 where none
    is): an image is kept iff mask.mean() >= 0.1 * (gt > 0).mean() and it has
    gt at all. Also returns `n_valid_images`, the count kept, to weight the
    means when they are accumulated over batches."""
    axes = tuple(range(1, disp_est.dim()))
    m = mask.float()
    msum = m.sum(axes)

    def pmean(x: torch.Tensor) -> torch.Tensor:
        return (x.float() * m).sum(axes) / msum.clamp(min=1.0)

    err = (disp_est - disp_gt).abs()
    vals = {
        "epe": pmean(err),
        "d1": pmean((err > 3.0) & (err > 0.05 * disp_gt.abs())),
        "thres1": pmean(err > 1.0),
        "thres2": pmean(err > 2.0),
        "thres3": pmean(err > 3.0),
    }
    gt_frac = (disp_gt > 0).float().mean(axes)
    # the multiplied form of mask_frac / gt_frac >= 0.1: no 0 / 0 where an
    # image has no gt (the reference drops such images through a NaN compare)
    keep = (m.mean(axes) >= 0.1 * gt_frac) & (gt_frac > 0)
    n_keep = keep.float().sum()
    out = {k: torch.where(keep, v, torch.zeros_like(v)).sum() / n_keep.clamp(min=1.0) for k, v in vals.items()}
    out["n_valid_images"] = n_keep
    return out


def disparity_class_confusion(
    class_logits: torch.Tensor, disp_gt: torch.Tensor, num_classes: int, class_width: float = 8.0
) -> torch.Tensor:
    """(num_classes, num_classes) float32 counts [gt class, predicted class].

    class_logits (B, D', H', W'): CVA logits with D' = num_classes; disp_gt
    (B, H, W) at full resolution. The gt class of a logit pixel is
    floor(mean of its (W // W')^2 gt pixels / class_width); pixels whose gt
    class lies outside [0, num_classes) are left out, not clipped in. The
    predicted class is the argmax over D'.
    """
    b, dp, hp, wp = class_logits.shape
    if dp != num_classes:
        raise ValueError(f"logits have {dp} classes, expected {num_classes}")
    scale = disp_gt.shape[-1] // wp
    pooled = disp_gt.float().reshape(b, hp, scale, wp, scale).mean(dim=(2, 4))
    gt_cls = torch.floor(pooled / class_width).long()
    valid = (gt_cls >= 0) & (gt_cls < num_classes)
    idx = gt_cls * num_classes + class_logits.argmax(dim=1)
    counts = torch.bincount(idx[valid], minlength=num_classes * num_classes)
    return counts.float().reshape(num_classes, num_classes)


def segmentation_scores(confusion: torch.Tensor) -> Dict[str, torch.Tensor]:
    """PA, mPA, mIoU and FWIoU of a confusion matrix [gt, pred]; a class with
    no gt pixel (mPA) or an empty union (mIoU) does not count in the means."""
    total = confusion.sum()
    diag = torch.diagonal(confusion)
    gt_per_class = confusion.sum(dim=1)
    union = gt_per_class + confusion.sum(dim=0) - diag
    zero = torch.zeros_like(diag)
    present, present_u = gt_per_class > 0, union > 0
    cpa = diag / gt_per_class.clamp(min=1e-12)
    iou = torch.where(present_u, diag / union.clamp(min=1e-12), zero)
    return {
        "pa": diag.sum() / total.clamp(min=1.0),
        "mpa": torch.where(present, cpa, zero).sum() / present.sum().clamp(min=1),
        "miou": iou.sum() / present_u.sum().clamp(min=1),
        "fwiou": (gt_per_class / total.clamp(min=1.0) * iou).sum(),
    }
