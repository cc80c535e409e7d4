"""Ground-truth disparity -> matching-probability volumes (port of
dcanet_tpu/ops/disp2prob.py; reference models/loss.py:26-163).

All functions take gt disparity (B, H, W) and return (B, maxdisp, H, W).
The reference's quirks are kept:
  * `laplace_disp2prob` ignores `variance` at its default of 1 (the
    reference's calProb does), and divides by it otherwise;
  * the valid mask is strict: start_disp < gt < start_disp + maxdisp - 1;
  * the output is `prob * mask + 1e-40`.
"""

from __future__ import annotations

import torch

_EPS = 1e-40


def _index_and_mask(gt: torch.Tensor, maxdisp: int, start_disp: int):
    if gt.dim() != 3:
        raise ValueError(f"expected gt (B, H, W), got {tuple(gt.shape)}")
    end_disp = start_disp + maxdisp - 1
    index = torch.arange(maxdisp, dtype=gt.dtype, device=gt.device).view(1, maxdisp, 1, 1)
    mask = ((gt > start_disp) & (gt < end_disp)).to(gt.dtype)
    return index, (gt * mask)[:, None], mask[:, None]


def laplace_disp2prob(gt: torch.Tensor, maxdisp: int, variance: float = 1.0, start_disp: int = 0) -> torch.Tensor:
    """softmax_d(-|d - gt| / variance), masked (models/loss.py:117-128)."""
    index, gt4, mask = _index_and_mask(gt, maxdisp, start_disp)
    scaled = -(index - gt4).abs()
    if variance != 1.0:
        scaled = scaled / variance
    return scaled.softmax(dim=1) * mask + _EPS


def gaussian_disp2prob(gt: torch.Tensor, maxdisp: int, variance: float = 1.0, start_disp: int = 0) -> torch.Tensor:
    """softmax_d(-(d - gt)^2 / variance), masked (models/loss.py:130-142)."""
    index, gt4, mask = _index_and_mask(gt, maxdisp, start_disp)
    scaled = -((index - gt4).abs() ** 2) / variance
    return scaled.softmax(dim=1) * mask + _EPS


def onehot_disp2prob(gt: torch.Tensor, maxdisp: int, variance: float = 0.5001, start_disp: int = 0) -> torch.Tensor:
    """Hard window |d - gt| < variance, no mask or eps (models/loss.py:144-163)."""
    if gt.dim() != 3:
        raise ValueError(f"expected gt (B, H, W), got {tuple(gt.shape)}")
    index = torch.arange(maxdisp, dtype=gt.dtype, device=gt.device).view(1, maxdisp, 1, 1)
    return ((index - gt[:, None]).abs() < variance).to(gt.dtype)
