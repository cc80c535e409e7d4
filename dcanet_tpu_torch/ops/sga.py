"""Semi-global (SGA) and local guided (LGA) cost aggregation, plain PyTorch
(port of dcanet_tpu/ops/sga.py, a `lax.scan` there, not Pallas).

SGA: per direction r in {down, up, right, left}, a first-order recurrence
along the scan line with 5 per-pixel weights:

  out[p, d] = w0[p]*cost[p, d] + w1[p]*out[p-r, d] + w2[p]*out[p-r, d-1]
            + w3[p]*out[p-r, d+1] + w4[p]*max_d' out[p-r, d']

with a zero "previous" line at the first step and zero padding at d-1 /
d+1; the four directions fuse by an elementwise max. Each direction pair
(down/up over H, right/left over W) runs as one Python loop whose step
updates both directions at once, on the whole (B, C, D, line) slab: the
weights broadcast over C and D (the JAX package vmaps over C).

LGA: per-pixel (2r+1)^2 spatial filters, separate for the d-1, d and d+1
planes, accumulated tap by tap without stacking the patches.

Both run in float32, also under bf16 autocast, and return the cost's dtype.
Layouts: cost (B, C, D, H, W); SGA weights (B, 4, 5, H, W) (direction-major,
directions 0=down, 1=up, 2=right, 3=left); LGA filters (B, 3, K2, H, W) with
K2 = (2r+1)^2 and tap k = dy*(2r+1) + dx.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sga_step(prev: torch.Tensor, c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One update. prev, c: (..., D, X); w: (..., 5, 1, X) broadcast over D."""
    padded = F.pad(prev, (0, 0, 1, 1))  # zero planes at d = -1 and d = D
    out = w[..., 0, :, :] * c
    out = torch.addcmul(out, w[..., 1, :, :], prev)
    out = torch.addcmul(out, w[..., 2, :, :], padded[..., :-2, :])  # prev[d - 1]
    out = torch.addcmul(out, w[..., 3, :, :], padded[..., 2:, :])  # prev[d + 1]
    return torch.addcmul(out, w[..., 4, :, :], prev.amax(dim=-2, keepdim=True))


def _scan_bidir(lines: torch.Tensor, w_fwd: torch.Tensor, w_bwd: torch.Tensor):
    """Forward (0 -> L) and backward (L -> 0) recurrences in one loop.

    lines: (L, B, C, D, X); w_fwd, w_bwd: (L, B, 5, 1, X) (one 1 for C rides
    in the step's broadcast below). Returns both (L, B, C, D, X) in line order.
    """
    n = lines.shape[0]
    cost = torch.stack([lines, lines.flip(0)], dim=1)  # (L, 2, B, C, D, X)
    weights = torch.stack([w_fwd, w_bwd.flip(0)], dim=1)[:, :, :, None]  # (L, 2, B, 1, 5, 1, X)
    prev = torch.zeros_like(cost[0])
    outs = []
    for i in range(n):
        prev = _sga_step(prev, cost[i], weights[i])
        outs.append(prev)
    out = torch.stack(outs)
    return out[:, 0], out[:, 1].flip(0)


def sga_aggregate(cost: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """4-direction semi-global aggregation with max fusion.

    cost: (B, C, D, H, W); weights: (B, 4, 5, H, W), already normalised.
    Returns (B, C, D, H, W)."""
    b, c, d, h, w = cost.shape
    if weights.shape != (b, 4, 5, h, w):
        raise ValueError(f"weights {tuple(weights.shape)} do not fit cost {tuple(cost.shape)}")
    with torch.autocast(device_type=cost.device.type, enabled=False):
        x, wt = cost.float(), weights.float()
        # rows: (H, B, C, D, W), weights (H, B, 4, 5, 1, W)
        rows = x.permute(3, 0, 1, 2, 4)
        w_rows = wt.permute(3, 0, 1, 2, 4)[:, :, :, :, None]
        down, up = _scan_bidir(rows, w_rows[:, :, 0], w_rows[:, :, 1])
        # columns: (W, B, C, D, H), weights (W, B, 4, 5, 1, H)
        cols = x.permute(4, 0, 1, 2, 3)
        w_cols = wt.permute(4, 0, 1, 2, 3)[:, :, :, :, None]
        right, left = _scan_bidir(cols, w_cols[:, :, 2], w_cols[:, :, 3])
        vertical = torch.maximum(down, up).permute(1, 2, 3, 0, 4)
        horizontal = torch.maximum(right, left).permute(1, 2, 3, 4, 0)
        return torch.maximum(vertical, horizontal).to(cost.dtype)


def lga3d(cost: torch.Tensor, filters: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Local guided aggregation over the d-1 / d / d+1 planes.

    cost: (B, C, D, H, W); filters: (B, 3, K2, H, W). Returns (B, C, D, H, W):
      out[d] = sum_k f[:, 0, k] * patch_k(cost[d-1]) + f[:, 1, k] * patch_k(cost[d])
             + f[:, 2, k] * patch_k(cost[d+1])
    with zero planes outside D and zero padding outside H and W."""
    b, c, d, h, w = cost.shape
    k = 2 * radius + 1
    if filters.shape != (b, 3, k * k, h, w):
        raise ValueError(f"filters {tuple(filters.shape)} do not fit cost {tuple(cost.shape)} at radius {radius}")
    with torch.autocast(device_type=cost.device.type, enabled=False):
        padded = F.pad(cost.float(), (radius, radius, radius, radius, 1, 1))  # (B, C, D+2, H+2r, W+2r)
        f = filters.float()[:, None, :, :, None]  # (B, 1, 3, K2, 1, H, W)
        out = None
        for dy in range(k):
            for dx in range(k):
                window = padded[..., dy : dy + h, dx : dx + w]
                for plane in range(3):
                    term = (window[:, :, plane : plane + d], f[:, :, plane, dy * k + dx])
                    out = term[0] * term[1] if out is None else torch.addcmul(out, *term)
        return out.to(cost.dtype)
