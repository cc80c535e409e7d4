"""A training curve: `cli train` with `--resume` per epoch and `cli eval` on
the TEST split after each epoch, from a random-init point at epoch 0. The
port's counterpart of the JAX package's tools/traincurve.py (whose curve is
TRAINCURVE.md), on the card unless asked for the CPU.

    python -m dcanet_tpu_torch.traincurve --root DIR --epochs 5 --batch 4 \\
        --dtype bfloat16 --logdir runs/curve --out curve.json [--device cpu]

DIR holds a SceneFlow-layout tree with a TRAIN and a TEST split, such as
`data/synthetic.py::write_procedural_sceneflow_tree` writes (1600 + 40
scenes at 320x640 for TRAINCURVE.md's run). Each epoch is one `cmd_train`
call under the sceneflow preset (its loss ladder, Adam 1e-3 on the
"12,20,24,28:2" decay, the random 256x512 crop), resuming from the newest
checkpoint in `<logdir>/ckpt`; the eval scores that checkpoint on the TEST
split at full size in the same dtype. The JSON holds one row per point:
epoch, steps, val EPE, D1, >1 px, and for the epochs trained the host
ms/step (between the first and the last metric read of the epoch, so the
first `print_freq` steps are its warm-up), pairs/s, the epoch's wall time
and its peak device memory ("not measured" on the CPU).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from dcanet_tpu_torch import cli
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.device import resolve_device


def _make_cfg(root: str, logdir: str, batch: int, dtype: str, epochs: int, print_freq: int, num_workers: int):
    return preset("sceneflow", data_root=root, batch_size=batch, dtype=dtype, logdir=logdir, epochs=epochs,
                  resume=True, print_freq=print_freq, num_workers=num_workers)


def ms_per_step(history: List[Dict[str, float]]) -> Optional[float]:
    """Host ms per step between the epoch's first and last metric read (the
    steps of one read share its time)."""
    last = {}  # read time -> the last step it read
    for r in history:
        last[r["time"]] = max(last.get(r["time"], r["step"]), r["step"])
    if len(last) < 2:
        return None
    t0, t1 = min(last), max(last)
    return 1e3 * (t1 - t0) / (last[t1] - last[t0])


def run_curve(root: str, epochs: int = 5, batch: int = 4, dtype: str = "bfloat16", logdir: str = "runs/traincurve",
              device: Optional[str] = None, print_freq: int = 100, num_workers: int = 8,
              say=print) -> List[Dict[str, object]]:
    """Train `epochs` epochs and score the TEST split after each; returns the
    rows (epoch 0: the random init). Resumes from `<logdir>/ckpt`."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    curve: List[Dict[str, object]] = []

    def point(epoch: int, steps: int, train: Optional[Dict[str, object]] = None) -> None:
        t0 = time.perf_counter()
        r = cli.cmd_eval(_make_cfg(root, logdir, batch, dtype, 1, print_freq, num_workers), device=str(dev))
        row = {"epoch": epoch, "steps": steps, "val_epe": float(r["epe"]), "val_d1": float(r["d1"]),
               "val_thres1": float(r["thres1"]), "eval_s": time.perf_counter() - t0, **(train or {})}
        curve.append(row)
        say(f"CURVE {json.dumps(row)}")

    point(0, 0)
    for e in range(epochs):
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        hist = cli.cmd_train(_make_cfg(root, logdir, batch, dtype, e + 1, print_freq, num_workers),
                             device=str(dev))
        wall = time.perf_counter() - t0
        if not hist:
            raise RuntimeError(f"epoch {e + 1}: cmd_train took no step (is {logdir} ahead of it?)")
        ms = ms_per_step(hist)
        train = {"train_steps": len(hist), "train_loss_last": hist[-1]["total"], "train_epe_last": hist[-1]["epe"],
                 "ms_per_step": ms, "pairs_per_s": None if ms is None else 1e3 * batch / ms, "train_wall_s": wall,
                 "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if cuda else "not measured"}
        point(e + 1, hist[-1]["step"] + 1, train)
    return curve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--logdir", default="runs/traincurve")
    ap.add_argument("--out", default="TRAINCURVE_TORCH.json")
    ap.add_argument("--device", default=None, help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--print-freq", type=int, default=100)
    ap.add_argument("--num-workers", type=int, default=8)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    curve = run_curve(a.root, a.epochs, a.batch, a.dtype, a.logdir, str(dev), a.print_freq, a.num_workers)
    out = {"dataset": "procedural SceneFlow layout (dcanet_tpu_torch/data/synthetic.py)", "preset": "sceneflow",
           "batch": a.batch, "dtype": a.dtype, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu", "curve": curve}
    Path(a.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(curve[-1]))


if __name__ == "__main__":
    main()
