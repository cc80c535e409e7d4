"""Meters and metric logging (the port's own copy of
dcanet_tpu/utils/experiment.py; reference utils/experiment.py:112-151).

`MetricLogger` appends scalar rows to `metrics.jsonl` and `metrics.csv`
under its logdir, writes image panels as PNG under `images/` with the port's
own encoder (`data/io.py::write_png`: the card's machine has no PIL), and
mirrors both to TensorBoard when asked and `torch.utils.tensorboard`
imports.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict

import numpy as np

from dcanet_tpu_torch.data.io import write_png


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class AverageMeterDict:
    """One AverageMeter per key."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    def update(self, values: Dict[str, float], n: int = 1) -> None:
        for k, v in values.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def mean(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self) -> None:
        for m in self.meters.values():
            m.reset()


class MetricLogger:
    """Scalar rows to JSONL and CSV, image panels to PNG; TensorBoard too
    when `use_tensorboard` and it imports. Close it when done."""

    def __init__(self, logdir: str, use_tensorboard: bool = False):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(logdir, "metrics.csv")
        self._csv_writer = None
        self._csv_file = None
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("torch.utils.tensorboard does not import; logging to JSONL and CSV only")
            else:
                self._tb = SummaryWriter(logdir)

    def log_image(self, step: int, tag: str, image: np.ndarray) -> str:
        """Write an (H, W, 3) panel, float in [0, 1] or uint8, as
        `images/<tag>_<step>.png` ('/' in the tag becomes '_'); returns the
        path."""
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        imgdir = os.path.join(self.logdir, "images")
        os.makedirs(imgdir, exist_ok=True)
        path = os.path.join(imgdir, f"{tag.replace('/', '_')}_{step:08d}.png")
        write_png(path, arr)
        if self._tb is not None:
            self._tb.add_image(tag, arr, step, dataformats="HWC")
        return path

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        row = {"step": step, "time": time.time()}
        row.update({prefix + k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._csv_writer is None:
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=list(row))
            if self._csv_file.tell() == 0:
                self._csv_writer.writeheader()
        try:
            self._csv_writer.writerow(row)
            self._csv_file.flush()
        except ValueError:
            pass  # keys other than the header's: the JSONL row has them all
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(prefix + k, float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._csv_file is not None:
            self._csv_file.close()
        if self._tb is not None:
            self._tb.close()
