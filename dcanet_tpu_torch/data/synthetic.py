"""Synthetic datasets in the SceneFlow and the KITTI 2015 layouts, drawn from a seed:

  SceneFlow   <root>/frames_finalpass/<split>/A/<seq>/{left,right}/<frame>.png
              <root>/frames_disparity/<split>/A/<seq>/left/<frame>.pfm
  KITTI 2015  <root>/{image_2,image_3}/<index:06d>_10.png
              <root>/disp_occ_0/<index:06d>_10.png (uint16, disparity x 256,
              0 where there is no gt)

Each left image is a blocky random texture; the right image is the left one
shifted by the disparity (left[y, x] = right[y, x - d]), which grows down the
image (rows of constant disparity between `min_disp` and `max_disp`), so the
pair is consistent with its ground truth. The KITTI gt is sparse as KITTI's
LiDAR gt is: none in the top quarter of the image, and 40 % of the pixels
below it. For smoke tests of the training path (`cli train`) and of the eval
path (`cli eval`, `cli infer --list`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from dcanet_tpu_torch.data.io import write_pfm, write_png

KITTI_GT_DENSITY = 0.4


def _shifted_pair(rng: np.random.Generator, disp_rows: np.ndarray, w: int, block: int, pad: int):
    """A blocky random texture (h, w + pad) -> the left image and the right
    one, each row shifted by its disparity."""
    h = len(disp_rows)
    base = rng.integers(0, 256, size=(h // block + 1, (w + pad) // block + 1, 3), dtype=np.uint8)
    tex = np.repeat(np.repeat(base, block, axis=0), block, axis=1)[:h, : w + pad]
    right = np.stack([tex[y, disp_rows[y] : disp_rows[y] + w] for y in range(h)])
    return tex[:, :w], right


def _disp_rows(h: int, min_disp: int, max_disp: int) -> np.ndarray:
    return min_disp + ((max_disp - min_disp) * np.arange(h)) // max(h - 1, 1)


def write_sceneflow_tree(
    root: Union[str, Path], num_pairs: int, hw: Tuple[int, int] = (540, 960), seed: int = 0,
    min_disp: int = 4, max_disp: int = 100, block: int = 4, split: str = "TRAIN",
) -> Path:
    """Write `num_pairs` pairs of size `hw` under `root`, in the FlyingThings3D
    `split` ("TRAIN" or "TEST", which `cli eval --preset sceneflow` reads);
    returns `root`."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    for i in range(num_pairs):
        seq = f"{i // 10:04d}"
        frame = f"{6 + i % 10:04d}"
        img_dir = root / "frames_finalpass" / split / "A" / seq
        disp_dir = root / "frames_disparity" / split / "A" / seq / "left"
        for d in (img_dir / "left", img_dir / "right", disp_dir):
            os.makedirs(d, exist_ok=True)
        disp_rows = _disp_rows(h, min_disp, max_disp)
        left, right = _shifted_pair(rng, disp_rows, w, block, max_disp + 1)
        write_png(img_dir / "left" / f"{frame}.png", left)
        write_png(img_dir / "right" / f"{frame}.png", right)
        write_pfm(disp_dir / f"{frame}.pfm", np.repeat(disp_rows[:, None], w, axis=1).astype(np.float32))
    return root


def write_kitti2015_tree(
    root: Union[str, Path], num_pairs: int, hw: Tuple[int, int] = (375, 1242), seed: int = 0,
    min_disp: int = 4, max_disp: int = 100, block: int = 4,
    out_of_range_pair: Optional[int] = None, maxdisp: int = 192,
) -> Path:
    """Write `num_pairs` pairs of size `hw` under `root`; returns `root`.

    Pair `out_of_range_pair` has the disparity `maxdisp` on all but the
    bottom 1/40 of its rows, so that under 10 % of its gt lies inside the
    eval mask (0 < gt < maxdisp) and the per-image skip rule drops it.
    """
    if max(max_disp, maxdisp) * 256 > np.iinfo(np.uint16).max:
        raise ValueError(f"KITTI's uint16 x256 gt holds disparities below 256, got {max(max_disp, maxdisp)}")
    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(root / sub, exist_ok=True)
    for i in range(num_pairs):
        disp_rows = _disp_rows(h, min_disp, max_disp)
        if i == out_of_range_pair:
            disp_rows = np.where(np.arange(h) < h - h // 40, maxdisp, disp_rows)
        left, right = _shifted_pair(rng, disp_rows, w, block, int(disp_rows.max()) + 1)
        valid = (rng.random((h, w)) < KITTI_GT_DENSITY) & (np.arange(h)[:, None] >= h // 4)
        gt = np.where(valid, disp_rows[:, None] * 256, 0).astype(np.uint16)
        name = f"{i:06d}_10.png"
        write_png(root / "image_2" / name, left)
        write_png(root / "image_3" / name, right)
        write_png(root / "disp_occ_0" / name, gt)
    return root
