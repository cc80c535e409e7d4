"""Trilinear / bilinear resizing and convex (RAFT-style) upsampling.

Port of dcanet_tpu/ops/upsample.py. Resizes use half-pixel-center sampling
(`align_corners=False`), which is what jax.image.resize does when it
upsamples (it antialiases only when it shrinks). Layouts are
channel-first: volumes (B, D, H, W) or (B, C, D, H, W), maps (B, H, W) or
(B, C, H, W); convex-upsample masks (B, 9*s*s, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_trilinear(x: torch.Tensor, scale: int, shard=None) -> torch.Tensor:
    """Trilinear upsampling of the (D, H, W) axes by `scale`.

    x: (B, D, H, W) or (B, C, D, H, W). With a `DispShard`
    (parallel/sharding.py), x is this rank's half-resolution planes
    [p0, p1) of a D-sharded volume and the result its planes [2 p0, 2 p1)
    (scale 2): output plane j samples input planes j/2 - 1/4 on either
    side, so the slab takes one plane each side, the edge plane repeated at
    the volume's ends (the clamp of the unsharded resize), and the middle
    2 (p1 - p0) output planes of the padded slab are this rank's.
    """
    if x.dim() == 4:
        return resize_trilinear(x[:, None], scale, shard)[:, 0]
    if x.dim() != 5:
        raise ValueError(f"expected rank 4/5, got {tuple(x.shape)}")
    if shard is not None:
        if scale != 2:
            raise ValueError(f"the D-sharded resize is 2x, got {scale}x")
        m = x.shape[2]
        return resize_trilinear(shard.halo(x, 1, 1, fill="edge"), 2).narrow(2, 2, 2 * m)
    size = tuple(s * scale for s in x.shape[2:])
    return F.interpolate(x, size=size, mode="trilinear", align_corners=False)


def resize_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear upsampling of the (H, W) axes by `scale`.

    x: (B, H, W) or (B, C, H, W).
    """
    if x.dim() == 3:
        return resize_bilinear(x[:, None], scale)[:, 0]
    if x.dim() != 4:
        raise ValueError(f"expected rank 3/4, got {tuple(x.shape)}")
    size = (x.shape[2] * scale, x.shape[3] * scale)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 zero-padded neighbourhood gather: (B, H, W) -> (B, 9, H, W) with
    neighbour index k = (dy+1)*3 + (dx+1), F.unfold's channel order."""
    b, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    return torch.stack(
        [xp[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)], dim=1
    )


def convex_upsample(disp: torch.Tensor, mask_logits: torch.Tensor, scale: int) -> torch.Tensor:
    """Convex-combination upsampling of a coarse disparity map.

    disp:        (B, H, W) at 1/scale resolution, in coarse-pixel units
                 (multiplied by `scale` here, as in the reference).
    mask_logits: (B, 9*scale**2, H, W), channel c = k*scale**2 + i*scale + j
                 with k the 3x3 neighbour index and (i, j) the subpixel.
    Returns (B, H*scale, W*scale); output pixel (h*s+i, w*s+j).
    """
    b, h, w = disp.shape
    if mask_logits.shape != (b, 9 * scale * scale, h, w):
        raise ValueError(f"mask {tuple(mask_logits.shape)} does not fit disparity {tuple(disp.shape)}")
    mask = mask_logits.view(b, 9, scale, scale, h, w).softmax(dim=1)
    neighbors = unfold3x3(scale * disp).view(b, 9, 1, 1, h, w)
    up = (mask * neighbors).sum(dim=1)  # (B, s_i, s_j, H, W)
    return up.permute(0, 3, 1, 4, 2).reshape(b, h * scale, w * scale)
