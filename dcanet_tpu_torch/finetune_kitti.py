"""The KITTI fine-tune leg: the reference's pretrain -> fine-tune workflow
(train_kitti.py) through the port's commands, on the card unless asked for
the CPU. The port's counterpart of the JAX package's tools/finetune_kitti.py
(whose result is FINETUNE.json).

    python -m dcanet_tpu_torch.finetune_kitti --pretrain CKPT_DIR --k12 DIR \\
        --k15 DIR --val DIR --epochs 8 --batch 4 --dtype bfloat16 \\
        --out finetune.json [--logdir runs/finetune_kitti] [--device cpu]

1. `cli export` of the newest checkpoint under CKPT_DIR (a SceneFlow run's
   `<logdir>/ckpt`, such as `traincurve.py` leaves) to
   `<logdir>/pretrained_export.pt`: parameters and BatchNorm statistics;
2. `cli eval --preset kitti --dataset kitti2015` of those weights on the
   held-out KITTI 2015 tree --val, batch 1 ("pretrained");
3. `cli train --preset kitti` on the kitti_mix of --k12 (KITTI 2012 layout)
   and --k15 (KITTI 2015 layout): sparse gt, photometric jitter and
   occlusion, 5x / 10x focal plus smooth-L1, the piecewise LR from 1e-3,
   initialised by `--loadckpt` from the export (a fresh optimiser at step
   0), --epochs epochs at --batch, saving after every epoch (the preset's
   `save_after_epoch` of 449 is set to 0, as the JAX tool does; neither CLI
   has a flag for it);
4. `cli eval` again on the newest checkpoint of that run ("finetuned N
   epochs").

The trees are what `data/synthetic.py::write_procedural_kitti_tree` writes
(the JAX leg's: 120 + 120 scenes at 376x1248, 24 held out). The JSON holds
the JAX file's keys (`workflow`, `preset`, `batch`, `curve` rows with `tag`,
`val_epe`, `val_d1`, `eval_s`; each row also the eval's host ms/pair) and
the port's own: `device`, `dtype`, the fine-tune's steps, host ms/step
(between its first and last metric read, `traincurve.ms_per_step`),
pairs/s, wall time and peak device memory ("not measured" on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from dcanet_tpu_torch import cli
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.device import resolve_device
from dcanet_tpu_torch.traincurve import ms_per_step

WORKFLOW = "sceneflow-pretrain -> kitti_mix finetune (--loadckpt)"
PRESET = "kitti (sparse gt, photometric+occlusion aug, 5x/10x focal)"
PRINT_FREQ = 20  # the fine-tune's metric reads, every PRINT_FREQ steps, as the JAX tool's


def run_finetune(pretrain: str, k12: str, k15: str, val: str, epochs: int = 8, batch: int = 4,
                 dtype: str = "bfloat16", logdir: str = "runs/finetune_kitti", device: Optional[str] = None,
                 say=print) -> Dict[str, object]:
    """The leg (module docstring); returns the JSON's content."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    weights = os.path.join(logdir, "pretrained_export.pt")
    os.makedirs(logdir, exist_ok=True)
    cli.cmd_export(os.path.dirname(os.path.abspath(pretrain)), weights)

    def point(tag: str, ckpt_dir: str) -> Dict[str, object]:
        t0 = time.perf_counter()
        cfg = preset("kitti", dataset="kitti2015", data_root=val, dtype=dtype, logdir=logdir, batch_size=1)
        r = cli.cmd_eval(cfg, ckpt_dir, str(dev))
        row = {"tag": tag, "val_epe": float(r["epe"]), "val_d1": float(r["d1"]),
               "eval_s": time.perf_counter() - t0, "eval_ms_per_pair": r.get("ms_per_pair")}
        say(f"CURVE {json.dumps(row)}")
        return row

    curve = [point("pretrained (sceneflow weights, domain gap)", pretrain)]
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = cli.cmd_train(preset("kitti", data_root=k12, data_root2=k15, batch_size=batch, dtype=dtype,
                                logdir=logdir, epochs=epochs, loadckpt=weights, save_after_epoch=0,
                                print_freq=PRINT_FREQ), str(dev))
    wall = time.perf_counter() - t0
    if not hist:
        raise RuntimeError(f"cmd_train took no step on {k12} + {k15}")
    say(f"finetune wall: {wall:.1f} s")
    ms = ms_per_step(hist)
    curve.append(point(f"finetuned {epochs} epochs", os.path.join(logdir, "ckpt")))
    return {"workflow": WORKFLOW, "preset": PRESET, "batch": batch, "curve": curve,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu", "dtype": dtype, "epochs": epochs,
            "train_steps": len(hist), "train_loss_last": hist[-1]["total"], "ms_per_step": ms,
            "pairs_per_s": None if ms is None else 1e3 * batch / ms, "train_wall_s": wall,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if cuda else "not measured"}


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pretrain", required=True, help="a SceneFlow run's checkpoint directory (<logdir>/ckpt)")
    ap.add_argument("--k12", required=True, help="a KITTI 2012 layout tree")
    ap.add_argument("--k15", required=True, help="a KITTI 2015 layout tree")
    ap.add_argument("--val", required=True, help="a held-out KITTI 2015 layout tree")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--logdir", default="runs/finetune_kitti")
    ap.add_argument("--out", default="FINETUNE_TORCH.json")
    ap.add_argument("--device", default=None, help="cuda (the default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    out = run_finetune(a.pretrain, a.k12, a.k15, a.val, a.epochs, a.batch, a.dtype, a.logdir, a.device)
    Path(a.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out["curve"]))
    return out


if __name__ == "__main__":
    main()
