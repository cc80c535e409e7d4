"""Stereo pairs drawn from the seed.

A scene is a smooth random texture (the right view) and a smooth random
disparity field; the left view samples the right one at x - d, so that the
pair is a true rectified stereo pair whose match lies inside the right view
where x >= d. Every seed gives the same sizes and disparity range; only the
content differs.

Serving pairs are made on the host (a KITTI image, 375 x 1242, in 0..255,
whitened per channel and zero-padded to the submission protocol's 384 x
1248: rows on top, columns on the right), as a client would send them.
Training batches are made on the device in a few calls, with the KITTI gt's
sparsity: a pixel keeps its disparity with probability `keep` where x >= d,
else 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _scenes(gen: torch.Generator, n: int, hw: Tuple[int, int], disp_range: Tuple[float, float], device):
    """(right (n, 3, H, W) in 0..1, left, disparity (n, H, W))."""
    h, w = hw
    coarse = torch.rand(n, 3, h // 4 + 1, w // 4 + 1, generator=gen, device=device)
    fine = torch.rand(n, 3, h, w, generator=gen, device=device)
    right = 0.8 * F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False) + 0.2 * fine
    field = torch.randn(n, 1, h // 32 + 2, w // 32 + 2, generator=gen, device=device)
    field = F.interpolate(field, size=(h, w), mode="bicubic", align_corners=False)[:, 0]
    lo, hi = disp_range
    disp = lo + (hi - lo) * torch.sigmoid(1.5 * field)
    xs = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    grid = torch.stack([2.0 * (xs - disp + 0.5) / w - 1.0, (2.0 * (ys + 0.5) / h - 1.0).expand(n, h, w)], -1)
    left = F.grid_sample(right, grid, mode="bilinear", padding_mode="border", align_corners=False)
    return right, left, disp


def _whiten_pad(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) -> per-channel zero mean, unit std, zero-padded to out_hw
    with the image at the bottom left."""
    img = (img - img.mean((0, 1), keepdims=True)) / np.maximum(img.std((0, 1), keepdims=True), 1e-6)
    out = np.zeros(out_hw + (3,), np.float32)
    out[out_hw[0] - img.shape[0]:, :img.shape[1]] = img
    return out


def serve_pairs(seed: int, traffic: dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    """traffic['pool'] (left, right) pairs, each (H, W, 3) float32 on the host."""
    gen = torch.Generator().manual_seed(seed)
    hw, out_hw = tuple(traffic["image_hw"]), tuple(traffic["input_hw"])
    right, left, _ = _scenes(gen, traffic["pool"], hw, tuple(traffic["disp_range"]), "cpu")
    to_np = lambda t: (255.0 * t).permute(1, 2, 0).numpy().astype(np.float32)  # noqa: E731
    return [(_whiten_pad(to_np(left[i]), out_hw), _whiten_pad(to_np(right[i]), out_hw)) for i in range(len(left))]


def train_batches(seed: int, traffic: dict, device) -> List[Dict[str, torch.Tensor]]:
    """traffic['pool'] global batches {left, right, disparity} on `device`,
    images normalised to zero mean and unit spread, gt sparse."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, hw = traffic["batch"], tuple(traffic["crop_hw"])
    out = []
    for _ in range(traffic["pool"]):
        right, left, disp = _scenes(gen, b, hw, tuple(traffic["disp_range"]), device)
        keep = torch.rand(disp.shape, generator=gen, device=device) < traffic["gt_keep"]
        inside = torch.arange(hw[1], device=device).view(1, 1, -1) >= disp
        gt = torch.where(keep & inside, disp, torch.zeros_like(disp))
        out.append({"left": (left - 0.5) / 0.25, "right": (right - 0.5) / 0.25, "disparity": gt})
    return out
