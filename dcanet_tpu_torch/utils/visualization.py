"""KITTI-style disparity-error colormap (the port's own copy of
dcanet_tpu/utils/visualization.py; reference utils/visualization.py:11-58):
10 log-spaced error buckets on the KITTI devkit palette. Pure numpy, for
eval image panels."""

from __future__ import annotations

import numpy as np


def gen_error_colormap() -> np.ndarray:
    """(10, 5): lower and upper bound of each bucket, then its RGB in [0, 1]."""
    cols = np.array(
        [
            [0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
            [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
            [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
            [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
            [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
            [3 / 3.0, 6 / 3.0, 254, 224, 144],
            [6 / 3.0, 12 / 3.0, 253, 174, 97],
            [12 / 3.0, 24 / 3.0, 244, 109, 67],
            [24 / 3.0, 48 / 3.0, 215, 48, 39],
            [48 / 3.0, float("inf"), 165, 0, 38],
        ],
        dtype=np.float32,
    )
    cols[:, 2:5] /= 255.0
    return cols


def disp_error_image(
    disp_est: np.ndarray, disp_gt: np.ndarray, abs_thres: float = 3.0, rel_thres: float = 0.05
) -> np.ndarray:
    """(H, W) estimate and gt -> (H, W, 3) float RGB: each pixel's error
    min(|e| / abs_thres, |e| / gt / rel_thres) coloured by bucket; black
    where gt <= 0."""
    h, w = disp_gt.shape
    mask = disp_gt > 0
    error = np.abs(disp_est - disp_gt)
    error[~mask] = 0
    rel = error / abs_thres
    with np.errstate(divide="ignore", invalid="ignore"):
        rel2 = np.where(mask, error / np.maximum(disp_gt, 1e-6) / rel_thres, 0.0)
    norm = np.minimum(rel, rel2)
    img = np.zeros((h, w, 3), np.float32)
    for c in gen_error_colormap():
        img[(norm >= c[0]) & (norm < c[1])] = c[2:5]
    img[~mask] = 0.0
    return img
