"""Command line of the port: `python -m dcanet_tpu_torch.cli {train,infer} ...`.

  train --preset sceneflow|kitti|eth3d|middlebury --data-root DIR
        [--data-root2 DIR] [--logdir DIR] [--epochs N] [--batch-size N]
        [--dtype float32|bfloat16] [--remat] [--resume] [--loadckpt PATH]
        [--seed N] [--maxdisp N] [--print-freq N] [--num-workers N]
        [--device cuda|cpu]
  infer --left L.png --right R.png --out disp.png [--submission]
        [--weights PATH | --logdir DIR] [--maxdisp 192] [--num-cva 3]
        [--dtype bf16|f32] [--device cuda|cpu]

`train` (dcanet_tpu/cli.py:87-197): DCANet(num_cva=3) from a reference init
drawn from --seed, Adam on the preset's LR schedule, the preset's dataset
and loss, a full checkpoint (model, BatchNorm statistics, optimizer, step)
under <logdir>/ckpt after each epoch; `--resume` continues from the newest,
`--loadckpt` starts from weights saved by `train.checkpoint.save_params_only`.
It prints `epoch E step S/N loss L epe E (R pairs/s)` every --print-freq
steps and appends the same numbers to <logdir>/train_log.jsonl.

Single-pair inference to a uint16 x256 PNG. `--submission` follows the
reference's benchmark-submission protocol (my_img.py:47-111): per-channel
whitening, a fixed 384x1248 pad/crop and a per-image time print. Without it
the images take the training normalisation (ImageNet statistics) and are
padded to multiples of 16. `--weights` takes an `.npz` of flat flax variables,
a checkpoint of `train` or a reference-keyed torch checkpoint. `--logdir DIR`
restores the weights of the newest `DIR/ckpt/ckpt_<step>.pt` that `train`
wrote (dcanet_tpu/cli.py:416-420; there the preset's logdir is the default,
here the flag is opt-in) and reads only. With neither, or with no checkpoint
under DIR, the model takes a reference init drawn from seed 0; infer prints
which weights it used. The model runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dcanet_tpu_torch.config import PRESETS, RunConfig, preset
from dcanet_tpu_torch.data.io import normalize_imagenet, read_image, write_kitti_submission_png
from dcanet_tpu_torch.data.submission import (
    from_submission_shape, pad_to_multiple, to_submission_shape, unpad, whiten_per_channel,
)
from dcanet_tpu_torch.device import resolve_device
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.weights import load_weights


def build_model(
    maxdisp: int = 192, num_cva: int = 3, weights: Optional[str] = None,
    device: Optional[str] = None, seed: int = 0,
) -> DCANet:
    """DCANet in eval mode on `device` (CUDA unless asked otherwise), with the
    given weights or a reference init drawn from `seed`."""
    dev = resolve_device(device)
    model = DCANet(maxdisp=maxdisp, num_cva=num_cva)
    if weights:
        model.load_state_dict(load_weights(weights, num_cva), strict=True)
    else:
        reference_init_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def _to_tensor(img: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)[None], np.float32)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _infer_weights(args: argparse.Namespace) -> Optional[str]:
    """The weights file infer loads (None: the seed-0 reference init)."""
    from dcanet_tpu_torch.train.checkpoint import latest_checkpoint

    if args.logdir is None:
        return args.weights
    path = latest_checkpoint(os.path.join(args.logdir, "ckpt"))
    if path is None:
        print(f"no checkpoint under {os.path.join(args.logdir, 'ckpt')}; using the reference init from seed 0")
        return None
    print(f"restored weights from {path}")
    return str(path)


def cmd_infer(args: argparse.Namespace) -> None:
    model = build_model(args.maxdisp, args.num_cva, _infer_weights(args), args.device)
    dev = next(model.parameters()).device
    if dev.type == "cuda" and args.dtype == "f32":
        # f32 means float32 arithmetic: cuDNN convolutions default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    if args.submission:
        left, orig_hw = to_submission_shape(whiten_per_channel(read_image(args.left)))
        right, _ = to_submission_shape(whiten_per_channel(read_image(args.right)))
    else:
        left, pads = pad_to_multiple(normalize_imagenet(read_image(args.left)), 16)
        right, _ = pad_to_multiple(normalize_imagenet(read_image(args.right)), 16)
    tl, tr = _to_tensor(left, dev), _to_tensor(right, dev)

    _sync(dev)
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.autocast(dev.type, torch.bfloat16, enabled=args.dtype == "bf16"):
        disp = model(tl, tr).disparity
    disp = disp[0].float().cpu().numpy()
    elapsed = time.perf_counter() - t0
    if args.submission:
        print(f"full inference time = {elapsed:.4f} seconds")  # my_img.py:103 protocol
        disp = from_submission_shape(disp, orig_hw)
    else:
        print(f"inference time: {elapsed:.3f}s")
        disp = unpad(disp, pads)
    write_kitti_submission_png(args.out, disp)
    print(f"wrote {args.out}")


def build_dataset(cfg: RunConfig, training: bool):
    """The preset's StereoDataset (dcanet_tpu/cli.py:24-53)."""
    from dcanet_tpu_torch.data.datasets import (
        StereoDataset, scan_eth3d, scan_kitti2012, scan_kitti2015, scan_middlebury, scan_sceneflow,
    )

    if cfg.dataset == "sceneflow":
        train, test = scan_sceneflow(cfg.data_root)
        return StereoDataset(train if training else test, training, "sceneflow")
    if cfg.dataset == "eth3d":
        return StereoDataset(scan_eth3d(cfg.data_root), training, "eth3d")
    if cfg.dataset == "middlebury":
        return StereoDataset(scan_middlebury(cfg.data_root), training, "middlebury", half_res=cfg.half_res)
    if cfg.dataset == "kitti2012":
        samples = scan_kitti2012(cfg.data_root)
    elif cfg.dataset == "kitti2015":
        samples = scan_kitti2015(cfg.data_root)
    elif cfg.dataset == "kitti_mix":
        samples = scan_kitti2012(cfg.data_root) + (scan_kitti2015(cfg.data_root2) if cfg.data_root2 else [])
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    return StereoDataset(samples, training, "kitti")


def build_train_state(cfg: RunConfig, steps_per_epoch: int, device: Optional[str] = None):
    """DCANet(num_cva=3) with a reference init from cfg.seed on `device`, Adam
    on the preset's LR schedule, autocast bf16 for dtype bfloat16."""
    from dcanet_tpu_torch.train.schedule import epoch_decay_schedule, kitti_finetune_schedule
    from dcanet_tpu_torch.train.state import create_train_state

    if cfg.model != "dcanet":
        raise ValueError(f"the port trains model 'dcanet' only, got {cfg.model!r}")
    dev = resolve_device(device)
    model = DCANet(maxdisp=cfg.maxdisp, num_cva=3, remat=cfg.remat)
    reference_init_(model, torch.Generator().manual_seed(cfg.seed))
    model.to(dev)
    if cfg.lr_spec:
        lr_fn = epoch_decay_schedule(cfg.base_lr, cfg.lr_spec, steps_per_epoch)
    else:
        lr_fn = kitti_finetune_schedule(steps_per_epoch)
    amp = {"float32": None, "bfloat16": torch.bfloat16}[cfg.dtype]
    return create_train_state(model, lr_fn, amp)


def cmd_train(cfg: RunConfig, device: Optional[str] = None) -> List[Dict[str, float]]:
    """Train per `cfg`; returns one record per step (epoch, step, the step's
    metrics and the host time at which they were read)."""
    from dcanet_tpu_torch.data.loader import Loader, device_prefetch
    from dcanet_tpu_torch.train.checkpoint import CheckpointManager, load_params_only
    from dcanet_tpu_torch.train.loop import LossConfig, train_step

    dev = resolve_device(device)
    if dev.type == "cuda" and cfg.dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    train_ds = build_dataset(cfg, training=True)
    print(f"train samples: {len(train_ds)}")
    loader = Loader(train_ds, cfg.batch_size, seed=cfg.seed, num_workers=cfg.num_workers)
    steps_per_epoch = max(len(loader), 1)
    state = build_train_state(cfg, steps_per_epoch, str(dev))
    print(f"model params: {sum(p.numel() for p in state.model.parameters()) / 1e6:.2f}M")
    print(f"device: {dev}, dtype {cfg.dtype}")

    ckpt = CheckpointManager(os.path.join(cfg.logdir, "ckpt"))
    if cfg.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        print(f"resumed from step {state.step}")
    elif cfg.loadckpt:
        load_params_only(cfg.loadckpt, state.model)
        print(f"loaded pretrained weights from {cfg.loadckpt}")

    loss_cfg = LossConfig(
        max_disp=cfg.maxdisp, focal_coefficient=cfg.focal_coefficient, sparse=cfg.sparse_gt, preset=cfg.loss_preset
    )
    history: List[Dict[str, float]] = []
    log_path = os.path.join(cfg.logdir, "train_log.jsonl")
    for epoch in range(state.step // steps_per_epoch, cfg.epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        pending, window = [], []  # metrics stay on the device until printed
        for bi, batch in enumerate(device_prefetch(loader, dev)):
            pending.append((state.step, train_step(state, batch, loss_cfg)))
            if (bi + 1) % cfg.print_freq == 0 or bi + 1 == steps_per_epoch:
                now = time.perf_counter()
                for step, metrics in pending:
                    rec = {"epoch": epoch, "step": step, **{k: float(v) for k, v in metrics.items()}, "time": now}
                    history.append(rec)
                    window.append(rec)
                pending = []
                mean = {k: sum(r[k] for r in window) / len(window) for k in ("total", "epe")}
                rate = cfg.batch_size * (bi + 1) / (time.time() - t0)
                print(f"epoch {epoch} step {bi + 1}/{steps_per_epoch} loss {mean['total']:.3f} "
                      f"epe {mean['epe']:.3f} ({rate:.2f} pairs/s)", flush=True)
                with open(log_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch, "step": state.step, **mean, "pairs_per_s": rate}) + "\n")
                window = []
        if epoch >= cfg.save_after_epoch and (epoch + 1) % cfg.save_every_epochs == 0:
            ckpt.save(state)
    print("training done")
    return history


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(prog="dcanet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("train", help="train DCANet(num_cva=3) with a dataset preset")
    st.add_argument("--preset", default="sceneflow", choices=sorted(PRESETS))
    st.add_argument("--data-root", default=None)
    st.add_argument("--data-root2", default=None)
    st.add_argument("--logdir", default=None)
    st.add_argument("--epochs", type=int, default=None)
    st.add_argument("--batch-size", type=int, default=None)
    st.add_argument("--dtype", choices=("float32", "bfloat16"), default=None)
    st.add_argument("--remat", action="store_true", default=None)
    st.add_argument("--resume", action="store_true", default=None)
    st.add_argument("--loadckpt", default=None, help="weights-only init (train.checkpoint.save_params_only)")
    st.add_argument("--seed", type=int, default=None)
    st.add_argument("--maxdisp", type=int, default=None)
    st.add_argument("--print-freq", type=int, default=None)
    st.add_argument("--num-workers", type=int, default=None)
    st.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp = sub.add_parser("infer", help="single-pair inference -> uint16 x256 PNG")
    sp.add_argument("--left", required=True)
    sp.add_argument("--right", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--submission", action="store_true",
                    help="my_img.py protocol: per-channel whitening + 384x1248 pad/crop")
    src = sp.add_mutually_exclusive_group()
    src.add_argument("--weights", default=None,
                     help=".npz of flax variables, a train checkpoint or a reference torch checkpoint")
    src.add_argument("--logdir", default=None, help="restore the newest DIR/ckpt/ckpt_<step>.pt of `train`")
    sp.add_argument("--maxdisp", type=int, default=192)
    sp.add_argument("--num-cva", type=int, default=3)
    sp.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.cmd == "train":
        overrides = {k: v for k, v in vars(args).items() if k not in ("cmd", "preset", "device") and v is not None}
        return cmd_train(preset(args.preset, **overrides), args.device)
    cmd_infer(args)


if __name__ == "__main__":
    main()
