"""Soft-argmin disparity regression (port of dcanet_tpu/ops/regression.py).

Probability volumes are (B, D, H, W); disparities are (B, H, W).
"""

from __future__ import annotations

import torch


def disparity_regression(prob: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Expected disparity under a (B, D, H, W) probability volume, D == maxdisp:
    returns (B, H, W) sum_d prob[:, d] * d."""
    if prob.dim() != 4 or prob.shape[1] != maxdisp:
        raise ValueError(f"expected (B, {maxdisp}, H, W), got {tuple(prob.shape)}")
    disp_values = torch.arange(maxdisp, dtype=prob.dtype, device=prob.device).view(1, maxdisp, 1, 1)
    return (prob * disp_values).sum(dim=1)


def softargmin_disparity(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Softmax over D of (B, D, H, W) cost logits, then the expected
    disparity: `disparity_regression(cost.softmax(1), maxdisp)`."""
    return disparity_regression(cost.softmax(dim=1), maxdisp)
