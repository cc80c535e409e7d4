"""Stereo metrics as masked means (port of dcanet_tpu/train/metrics.py:28-66;
reference utils/metrics.py and util.py:55-74). Inputs are (B, H, W); each
metric is a global masked mean over the batch."""

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
