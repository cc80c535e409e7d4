"""A synthetic dataset in the SceneFlow FlyingThings3D layout, drawn from a seed:

  <root>/frames_finalpass/TRAIN/A/<seq>/{left,right}/<frame>.png
  <root>/frames_disparity/TRAIN/A/<seq>/left/<frame>.pfm

Each left image is a blocky random texture; the right image is the left one
shifted by the disparity (left[y, x] = right[y, x - d]), which grows down the image (rows of constant
disparity between `min_disp` and `max_disp`), so the pair is consistent with
its ground truth. For smoke tests of the training path (`cli train`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from dcanet_tpu_torch.data.io import write_pfm, write_png


def write_sceneflow_tree(
    root: Union[str, Path], num_pairs: int, hw: Tuple[int, int] = (540, 960), seed: int = 0,
    min_disp: int = 4, max_disp: int = 100, block: int = 4,
) -> Path:
    """Write `num_pairs` pairs of size `hw` under `root`; returns `root`."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    for i in range(num_pairs):
        seq = f"{i // 10:04d}"
        frame = f"{6 + i % 10:04d}"
        img_dir = root / "frames_finalpass" / "TRAIN" / "A" / seq
        disp_dir = root / "frames_disparity" / "TRAIN" / "A" / seq / "left"
        for d in (img_dir / "left", img_dir / "right", disp_dir):
            os.makedirs(d, exist_ok=True)
        pad = max_disp + 1
        base = rng.integers(0, 256, size=(h // block + 1, (w + pad) // block + 1, 3), dtype=np.uint8)
        tex = np.repeat(np.repeat(base, block, axis=0), block, axis=1)[:h, : w + pad]
        disp_rows = min_disp + ((max_disp - min_disp) * np.arange(h)) // max(h - 1, 1)
        left = tex[:, :w]  # left[x] = right[x - d]
        right = np.stack([tex[y, disp_rows[y] : disp_rows[y] + w] for y in range(h)])
        write_png(img_dir / "left" / f"{frame}.png", left)
        write_png(img_dir / "right" / f"{frame}.png", right)
        write_pfm(disp_dir / f"{frame}.pfm", np.repeat(disp_rows[:, None], w, axis=1).astype(np.float32))
    return root
