"""Per-dataset test-time geometry (the port's own copy of
dcanet_tpu/data/eval_protocol.py, on channel-first images).

The reference evaluates each benchmark at a geometry of its own:

  kitti       bottom-right crop of images and gt to at most 368x1232
              (dataloader/datasets.py:320-333), then pad to /16 (a no-op at
              the protocol size, train_kitti.py:131-144)
  eth3d       zero-pad the top to 768 and the right to 1024, images and gt
              (dataloader/datasets.py:409-429); gt == 0 is masked
  middlebury  replicate-pad to /64, split top/bottom and left/right
              (InputPadder, dataloader/datasets.py:530-540, 691-705); the
              gt is zero-padded to the same split, so pads = (0, 0)
  sceneflow   zero-pad the top and the right to /16 (main_dca.py:153-174);
  and any other dataset

`eval_transform` takes a sample of `data/datasets.py::StereoDataset` (left
and right (3, H, W), disparity (H, W)) and returns (left, right, gt, pads),
with `pads = (top, right)` relative to the returned gt:
`submission.unpad(prediction, pads)` aligns the model's output with it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from dcanet_tpu_torch.data.submission import pad_to_multiple

KITTI_H, KITTI_W = 368, 1232
ETH3D_H, ETH3D_W = 768, 1024


def _pad16(left: np.ndarray, right: np.ndarray):
    left, pads = pad_to_multiple(left, 16, channels_first=True)
    right, _ = pad_to_multiple(right, 16, channels_first=True)
    return left, right, pads


def eval_transform(
    item: Dict[str, np.ndarray], protocol: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    left, right, gt = item["left"], item["right"], item["disparity"]
    h, w = gt.shape
    if protocol == "kitti":
        ch, cw = min(KITTI_H, h), min(KITTI_W, w)
        left, right = left[:, h - ch :, w - cw :], right[:, h - ch :, w - cw :]
        left, right, pads = _pad16(left, right)
        return left, right, gt[h - ch :, w - cw :], pads
    if protocol == "eth3d":
        top, rp = max(ETH3D_H - h, 0), max(ETH3D_W - w, 0)
        left, right = (np.pad(x, [(0, 0), (top, 0), (0, rp)]) for x in (left, right))
        left, right, pads = _pad16(left, right)
        return left, right, np.pad(gt, [(top, 0), (0, rp)]), pads
    if protocol == "middlebury":
        left, (top, rcols) = pad_to_multiple(left, 64, mode="replicate", channels_first=True)
        right, _ = pad_to_multiple(right, 64, mode="replicate", channels_first=True)
        gt = np.pad(gt, [(top // 2, top - top // 2), (rcols // 2, rcols - rcols // 2)])
        return left, right, gt, (0, 0)
    left, right, pads = _pad16(left, right)
    return left, right, gt, pads
