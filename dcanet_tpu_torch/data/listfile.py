"""List-file datasets (the port's own copy of dcanet_tpu/data/listfile.py;
reference datasets/data_io.py and datasets/__init__.py): each line of a list
names `left right [disparity]` relative to a data root."""

from __future__ import annotations

import os
from typing import List

from dcanet_tpu_torch.data.datasets import StereoDataset, StereoSample


def read_list_file(list_path: str, root: str) -> List[StereoSample]:
    """Each non-empty line: `left_rel right_rel [disp_rel]` (datasets/data_io.py:5-20)."""
    samples = []
    with open(list_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            disp = os.path.join(root, parts[2]) if len(parts) > 2 else None
            samples.append(StereoSample(os.path.join(root, parts[0]), os.path.join(root, parts[1]), disp))
    return samples


def make_listfile_dataset(list_path: str, root: str, training: bool, preset: str = "sceneflow", **kw) -> StereoDataset:
    return StereoDataset(read_list_file(list_path, root), training, preset, **kw)


# name registry, as datasets/__init__.py:4-7
__datasets__ = {
    "sceneflow": lambda list_path, root, training, **kw: make_listfile_dataset(
        list_path, root, training, "sceneflow", **kw
    ),
    "kitti": lambda list_path, root, training, **kw: make_listfile_dataset(list_path, root, training, "kitti", **kw),
}
