"""KITTI benchmark-submission preprocessing (the reference's my_img.py protocol).

The port's own copy of dcanet_tpu/data/submission.py:
  * per-channel whitening: (x - mean(channel)) / std(channel), per image
    (my_img.py:47-69; not the ImageNet statistics used in training);
  * fixed-shape transform to (384, 1248): zero-pad anchored bottom-left (rows
    on top, columns on the right) when the image is smaller, else
    center-crop vertically / left-crop horizontally (my_img.py:71-87);
  * inverse: strip the top pad / width pad from the disparity (my_img.py:105-108).
Images are (H, W, C) numpy arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SUBMISSION_H, SUBMISSION_W = 384, 1248


def whiten_per_channel(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint-range -> per-channel zero-mean/unit-std float32."""
    img = img.astype(np.float32)
    mean = img.mean(axis=(0, 1), keepdims=True)
    std = img.std(axis=(0, 1), keepdims=True)
    return (img - mean) / np.maximum(std, 1e-6)


def to_submission_shape(
    img: np.ndarray, crop_h: int = SUBMISSION_H, crop_w: int = SUBMISSION_W
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """(H, W, C) -> (crop_h, crop_w, C) + the original (h, w) for unpadding."""
    h, w = img.shape[:2]
    if h <= crop_h and w <= crop_w:
        out = np.zeros((crop_h, crop_w) + img.shape[2:], np.float32)
        out[crop_h - h :, :w] = img
    else:
        sy = (h - crop_h) // 2
        out = img[sy : sy + crop_h, :crop_w].astype(np.float32)
    return out, (h, w)


def from_submission_shape(
    disp: np.ndarray, orig_hw: Tuple[int, int], crop_h: int = SUBMISSION_H, crop_w: int = SUBMISSION_W
) -> np.ndarray:
    """Predicted (crop_h, crop_w) -> the original (h, w) region."""
    h, w = orig_hw
    if h <= crop_h and w <= crop_w:
        return disp[crop_h - h :, :w]
    return disp


def pad_to_multiple(img: np.ndarray, multiple: int = 16) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad (H, W, ...) to multiples of `multiple`, rows on top and columns
    on the right. Returns (padded, (top, right))."""
    h, w = img.shape[:2]
    top = (multiple - h % multiple) % multiple
    right = (multiple - w % multiple) % multiple
    pads = [(top, 0), (0, right)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pads), (top, right)


def unpad(disp: np.ndarray, pads: Tuple[int, int]) -> np.ndarray:
    """Strip the top rows / right columns that pad_to_multiple added."""
    top, right = pads
    w = disp.shape[-1]
    return disp[..., top:, : w - right]
