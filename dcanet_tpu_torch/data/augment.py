"""Training augmentations (numpy, host-side); the port's own copy of
dcanet_tpu/data/augment.py.

Mirrors the reference's KITTI/ETH3D/Middlebury training path
(dataloader/datasets.py:283-306): asymmetric photometric jitter
(brightness U(0.5,2), gamma U(0.8,1.2), contrast U(0.8,1.2), drawn
independently for left/right), random crop, and a 20%-probability
rectangular mean-patch occlusion in the right image. Photometric math
matches torchvision.transforms.functional on uint8-range images.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img * factor, 0.0, 255.0)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    return np.clip(255.0 * gain * np.power(img / 255.0, gamma), 0.0, 255.0)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # torchvision: blend with the mean of the grayscale image
    gray = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    mean = gray.mean()
    return np.clip(factor * img + (1.0 - factor) * mean, 0.0, 255.0)


def photometric_pair(
    left: np.ndarray, right: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Asymmetric jitter, parameter ranges per dataloader/datasets.py:283-291."""
    brightness = rng.uniform(0.5, 2.0, 2)
    gamma = rng.uniform(0.8, 1.2, 2)
    contrast = rng.uniform(0.8, 1.2, 2)
    out = []
    for i, img in enumerate((left, right)):
        img = adjust_brightness(img, brightness[i])
        img = adjust_gamma(img, gamma[i])
        img = adjust_contrast(img, contrast[i])
        out.append(img)
    return out[0], out[1]


def occlusion_patch(right: np.ndarray, rng: np.random.Generator, prob: float = 0.2) -> np.ndarray:
    """Mean-fill a random rectangle in the right image
    (dataloader/datasets.py:301-306: sx U(35,100) rows, sy U(25,75) cols)."""
    if rng.binomial(1, prob):
        h, w = right.shape[:2]
        sx = int(rng.uniform(35, 100))
        sy = int(rng.uniform(25, 75))
        if h > 2 * sx and w > 2 * sy:
            cx = int(rng.uniform(sx, h - sx))
            cy = int(rng.uniform(sy, w - sy))
            right = right.copy()
            right[cx - sx : cx + sx, cy - sy : cy + sy] = right.mean(axis=(0, 1))
    return right


def random_crop(
    left: np.ndarray,
    right: np.ndarray,
    disp: np.ndarray,
    crop_hw: Tuple[int, int],
    rng: np.random.Generator,
):
    th, tw = crop_hw
    h, w = left.shape[:2]
    assert h >= th and w >= tw, (left.shape, crop_hw)
    y = int(rng.integers(0, h - th + 1))
    x = int(rng.integers(0, w - tw + 1))
    return (
        left[y : y + th, x : x + tw],
        right[y : y + th, x : x + tw],
        disp[y : y + th, x : x + tw],
    )
