"""Command line of the port: `python -m dcanet_tpu_torch.cli infer ...`.

  infer --left L.png --right R.png --out disp.png [--submission]
        [--weights PATH] [--maxdisp 192] [--num-cva 3] [--dtype bf16|f32]
        [--device cuda|cpu]

Single-pair inference to a uint16 x256 PNG. `--submission` follows the
reference's benchmark-submission protocol (my_img.py:47-111): per-channel
whitening, a fixed 384x1248 pad/crop and a per-image time print. Without it
the images take the training normalisation (ImageNet statistics) and are
padded to multiples of 16. `--weights` takes an `.npz` of flat flax variables
or a reference-keyed torch checkpoint; without it the model takes a reference
init drawn from seed 0. The model runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

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


def cmd_infer(args: argparse.Namespace) -> None:
    model = build_model(args.maxdisp, args.num_cva, args.weights, args.device)
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


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="dcanet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("infer", help="single-pair inference -> uint16 x256 PNG")
    sp.add_argument("--left", required=True)
    sp.add_argument("--right", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--submission", action="store_true",
                    help="my_img.py protocol: per-channel whitening + 384x1248 pad/crop")
    sp.add_argument("--weights", default=None, help=".npz of flax variables or a reference torch checkpoint")
    sp.add_argument("--maxdisp", type=int, default=192)
    sp.add_argument("--num-cva", type=int, default=3)
    sp.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.cmd == "infer":
        cmd_infer(args)


if __name__ == "__main__":
    main()
