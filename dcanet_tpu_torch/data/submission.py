"""KITTI benchmark-submission preprocessing (the reference's my_img.py protocol).

The port's own copy of dcanet_tpu/data/submission.py:
  * per-channel whitening: (x - mean(channel)) / std(channel), per image
    (my_img.py:47-69; not the ImageNet statistics used in training);
  * fixed-shape transform to (384, 1248): zero-pad anchored bottom-left (rows
    on top, columns on the right) when the image is smaller, else
    center-crop vertically / left-crop horizontally (my_img.py:71-87);
  * inverse: strip the top pad / width pad from the disparity (my_img.py:105-108);
  * eval padding to a multiple (`pad_to_multiple`, zero or replicate, also
    for channel-first images) and its inverse for the top-right zero mode
    (`unpad`), the port's own copy of dcanet_tpu/data/loader.py:48-76.
Images are (H, W, C) numpy arrays unless a function says otherwise.
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


def pad_to_multiple(
    img: np.ndarray, multiple: int = 16, mode: str = "top_right_zero", channels_first: bool = False
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Pad an image to multiples of `multiple` in H and W: (H, W, ...), or
    (..., H, W) with `channels_first`. Returns (padded, (top, right)), the
    rows and columns added in all.

    top_right_zero: zero rows on top, zero columns on the right (main_dca eval).
    replicate:      edge rows and columns, split top/bottom and left/right
                    (InputPadder, the Middlebury eval).
    """
    h, w = img.shape[-2:] if channels_first else img.shape[:2]
    top = (multiple - h % multiple) % multiple
    right = (multiple - w % multiple) % multiple
    if mode == "top_right_zero":
        hw_pads, np_mode = [(top, 0), (0, right)], "constant"
    elif mode == "replicate":
        hw_pads, np_mode = [(top // 2, top - top // 2), (right // 2, right - right // 2)], "edge"
    else:
        raise ValueError(f"unknown padding mode {mode!r}")
    rest = [(0, 0)] * (img.ndim - 2)
    return np.pad(img, rest + hw_pads if channels_first else hw_pads + rest, mode=np_mode), (top, right)


def unpad(disp: np.ndarray, pads: Tuple[int, int]) -> np.ndarray:
    """Strip the top rows / right columns that pad_to_multiple added."""
    top, right = pads
    w = disp.shape[-1]
    return disp[..., top:, : w - right]
