"""Command line of the port: `python -m dcanet_tpu_torch.cli {train,eval,infer,export} ...`.

  train  --preset sceneflow|kitti|eth3d|middlebury --data-root DIR
         [--data-root2 DIR] [--model NAME] [--logdir DIR] [--epochs N] [--batch-size N]
         [--dtype float32|bfloat16] [--remat] [--resume] [--loadckpt PATH]
         [--seed N] [--maxdisp N] [--print-freq N] [--num-workers N]
         [--n-data-shards N] [--n-disp-shards N] [--device cuda|cpu]
  eval   --preset P [--dataset D] --data-root DIR [--data-root2 DIR]
         [--model NAME] [--maxdisp N] [--dtype float32|bfloat16] [--logdir DIR]
         [--ckpt DIR] [--log-images N] [--vis-band lo:hi] [--seed N]
         [--n-disp-shards N] [--device cuda|cpu]
  infer  --left L.png --right R.png --out disp.png [--submission]
         | --list FILE --data-root DIR [--save-path DIR]
         [--weights PATH | --logdir DIR] [--model dcanet] [--maxdisp 192]
         [--dtype float32|bfloat16] [--device cuda|cpu]
  export --logdir DIR --out PATH

`train` (dcanet_tpu/cli.py:87-197): the registry's model (`dcanet`,
DCANet(num_cva=3), unless --model or the config names another; every
name of `models/registry.py`, `--remat` for the DCANet family only) from
a reference init drawn from --seed, Adam on the preset's LR schedule, the
preset's dataset and loss, a full checkpoint (model, BatchNorm statistics,
optimizer, step) under <logdir>/ckpt after each epoch; `--resume` continues from the newest,
`--loadckpt` starts from weights saved by `train.checkpoint.save_params_only`
(what `export` writes). Every --print-freq steps it writes the means of
every train metric since the last such row, prefixed `train/`, to
<logdir>/metrics.jsonl and .csv (and to TensorBoard under
`RunConfig.use_tensorboard`), as the JAX CLI does: the steps at the end of
an epoch carry over into the next row. It prints `epoch E step S/N loss L
epe E (R pairs/s)` every --print-freq steps and at the end of an epoch, and
appends the same numbers to <logdir>/train_log.jsonl. `RunConfig.debug_nans` runs the steps under
`torch.autograd.set_detect_anomaly`, which raises at the first backward
that returns NaN.

`train` runs over processes, one per card, started with the JAX
package's variables (`DCANET_COORDINATOR=host:port`,
`DCANET_NUM_PROCESSES`, `DCANET_PROCESS_ID`; NCCL on CUDA, gloo on the
CPU), or inside a process group the caller formed, laid out as a (data,
disp) grid: `--n-disp-shards N` (default 1) ranks split every cost
volume's disparity planes (DCANet family only; `parallel/sharding.py`),
and the processes over N make the data axis (`--n-data-shards`, when
given, must equal that). `--batch-size` is the global batch over the data
axis and must divide by it (the ranks of a data row load the same share,
`data/loader.py::shard_for_host`); BatchNorm statistics, loss means and
gradients are those of the global batch, so a grid takes the steps of one
process at the same `--batch-size`. Process 0 alone prints, logs and
writes checkpoints. `infer` and `export` run in one process.

`eval` (dcanet_tpu/cli.py:228-358) scores the preset's test split the way
the reference's test loops do: each benchmark's own test-time geometry
(`data/eval_protocol.py`), EPE, D1 and >1/2/3 px per image with the
under-10 %-valid skip, averaged over the images kept, on the mask
0 < gt < maxdisp; and for every CVA volume the DCA module's disparity-class
PA / mPA / mIoU / FWIoU (`vol<i>/...`; the bare keys are the last volume's;
none for a model without class logits: `gwcnet-*`, `ganet`).
The weights are the newest checkpoint under --ckpt (default <logdir>/ckpt),
else a reference init drawn from --seed. `--log-images N` writes image
panels of the first N pairs under <logdir>/images; the results, with the
host ms/pair after the first pair, go to <logdir>/metrics.jsonl and .csv.
`--n-disp-shards N` runs it as N processes, started as `train`'s are, that
split every cost volume's disparity planes between them (DCANet family
only; `parallel/sharding.py`): each builds and aggregates its own planes,
and they exchange the planes and reductions the 3D chain needs. Every rank
scores every pair and returns the same results (rank 0's host times);
rank 0 alone prints and writes.

`infer`: single-pair inference to a uint16 x256 PNG. `--submission` follows
the reference's benchmark-submission protocol (my_img.py:47-111): per-channel
whitening, a fixed 384x1248 pad/crop and a per-image time print. Without it
the images take the training normalisation (ImageNet statistics) and are
padded to multiples of 16. `--dtype bfloat16` (alias `bf16`) runs the
forward under bf16 autocast; `float32` (alias `f32`, the default) with TF32
off. `--list FILE` runs the submission protocol over
the names in FILE (one per line), read from <data-root>/image_{2,3}/<name>
and written to <save-path>/<name> (my_img.py:113-131), with each image's
time and the total. `--weights` takes an `.npz` of flat flax variables, a
checkpoint of `train`, a file of `export` or a reference-keyed torch
checkpoint. `--logdir DIR` restores the weights of the newest
`DIR/ckpt/ckpt_<step>.pt` that `train` wrote (dcanet_tpu/cli.py:416-420;
there the preset's logdir is the default, here the flag is opt-in) and
reads only. With neither, or with no checkpoint under DIR, the model takes a
reference init drawn from seed 0; infer prints which weights it used.

`export` writes the weights of the newest checkpoint under <logdir>/ckpt
alone (parameters and BatchNorm statistics, in `save_params_only`'s format);
without a checkpoint it raises and writes nothing.

Every command but `export` runs the model on CUDA unless `--device cpu` is
given, and raises without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from dcanet_tpu_torch.config import PRESETS, RunConfig, preset
from dcanet_tpu_torch.data.io import normalize_imagenet, read_image, write_kitti_submission_png
from dcanet_tpu_torch.data.submission import (
    from_submission_shape, pad_to_multiple, to_submission_shape, unpad, whiten_per_channel,
)
from dcanet_tpu_torch.device import resolve_device
from dcanet_tpu_torch.models.registry import make_model
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.weights import load_weights


def build_model(
    name: str = "dcanet", maxdisp: int = 192, weights: Optional[Union[str, Path]] = None,
    device: Optional[Union[str, torch.device]] = None, seed: int = 0, constrain_volume=None,
) -> torch.nn.Module:
    """The registry's model `name` in eval mode on `device` (CUDA unless asked
    otherwise), with the given weights or a reference init drawn from `seed`;
    `constrain_volume` (a disparity-sharding plan) for the DCANet family."""
    dev = resolve_device(device)
    kw = {} if constrain_volume is None else {"constrain_volume": constrain_volume}
    model = make_model(name, maxdisp=maxdisp, **kw)
    if weights:
        model.load_state_dict(load_weights(weights, model), strict=True)
    else:
        reference_init_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def _to_tensor(img: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)[None], np.float32)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _no_tf32(device: torch.device) -> None:
    """float32 means float32 arithmetic: cuDNN convolutions default to TF32."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _lead_printer(lead: bool):
    """print (flushed) on the rank that leads, nothing on the others."""
    return (lambda msg: print(msg, flush=True)) if lead else (lambda msg: None)


def _newest_checkpoint(directory: str, seed: int, say=print) -> Optional[Path]:
    """The newest checkpoint of `train` under `directory`, or None when there
    is none (the model then takes the reference init drawn from `seed`);
    says which. Reads only."""
    from dcanet_tpu_torch.train.checkpoint import latest_checkpoint

    path = latest_checkpoint(directory)
    if path is None:
        say(f"no checkpoint under {directory}; using the reference init from seed {seed}")
    else:
        say(f"restored weights from {path}")
    return path


def _forward(model: torch.nn.Module, left: np.ndarray, right: np.ndarray, bf16: bool) -> Tuple[np.ndarray, float]:
    """(H, W, 3) images -> the (H, W) disparity on the host, and the seconds
    from the pair on the device to the disparity on the host."""
    dev = next(model.parameters()).device
    tl, tr = _to_tensor(left, dev), _to_tensor(right, dev)
    _sync(dev)
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.autocast(dev.type, torch.bfloat16, enabled=bf16):
        disp = model(tl, tr).disparity
    disp = disp[0].float().cpu().numpy()
    return disp, time.perf_counter() - t0


def _submission_disparity(model: torch.nn.Module, left_path, right_path, bf16: bool) -> Tuple[np.ndarray, float]:
    """One pair through the submission protocol: the disparity at the
    images' own size, and the forward's seconds (`_forward`)."""
    left, orig_hw = to_submission_shape(whiten_per_channel(read_image(left_path)))
    right, _ = to_submission_shape(whiten_per_channel(read_image(right_path)))
    disp, elapsed = _forward(model, left, right, bf16)
    return from_submission_shape(disp, orig_hw), elapsed


def cmd_infer(args: argparse.Namespace) -> None:
    weights = args.weights
    if args.logdir is not None:
        weights = _newest_checkpoint(os.path.join(args.logdir, "ckpt"), 0)
    model = build_model(args.model, args.maxdisp, weights, args.device)
    bf16 = args.dtype == "bfloat16"
    if not bf16:
        _no_tf32(next(model.parameters()).device)
    if args.list:
        return cmd_infer_list(model, args.list, args.data_root, args.save_path, bf16)
    if args.submission:
        disp, elapsed = _submission_disparity(model, args.left, args.right, bf16)
        print(f"full inference time = {elapsed:.4f} seconds")  # my_img.py:103 protocol
    else:
        left, pads = pad_to_multiple(normalize_imagenet(read_image(args.left)), 16)
        right, _ = pad_to_multiple(normalize_imagenet(read_image(args.right)), 16)
        disp, elapsed = _forward(model, left, right, bf16)
        print(f"inference time: {elapsed:.3f}s")
        disp = unpad(disp, pads)
    write_kitti_submission_png(args.out, disp)
    print(f"wrote {args.out}")


def cmd_infer_list(model: torch.nn.Module, list_path: str, data_root: str, save_path: str, bf16: bool) -> None:
    """The submission protocol over a KITTI test list (my_img.py:113-131):
    each line names a file under <data_root>/image_2 and image_3; the
    disparities go to <save_path>/<name> as uint16 x256 PNGs."""
    with open(list_path) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    os.makedirs(save_path, exist_ok=True)
    t0 = time.perf_counter()
    for name in names:
        disp, elapsed = _submission_disparity(
            model, os.path.join(data_root, "image_2", name), os.path.join(data_root, "image_3", name), bf16
        )
        print(f"{name}: {elapsed:.4f} s")
        write_kitti_submission_png(os.path.join(save_path, name), disp)
    print(f"full inference time = {time.perf_counter() - t0:.2f} seconds")


def cmd_export(logdir: str, out: str) -> Path:
    """Write the weights of the newest checkpoint under <logdir>/ckpt in
    `save_params_only`'s format; raises FileNotFoundError, writing nothing,
    when there is none. Returns the checkpoint exported."""
    from dcanet_tpu_torch.train.checkpoint import export_params_only, latest_checkpoint

    path = latest_checkpoint(os.path.join(logdir, "ckpt"))
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {os.path.join(logdir, 'ckpt')}: nothing to export")
    export_params_only(path, out)
    print(f"exported the weights of {path} to {out}")
    return path


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


def build_train_state(cfg: RunConfig, steps_per_epoch: int, device: Optional[str] = None, mesh=None):
    """The registry's cfg.model with a reference init from cfg.seed on
    `device`, Adam on the preset's LR schedule, autocast bf16 for dtype
    bfloat16. `remat`, and the disparity-sharding plan of a `mesh` with a
    disp axis above 1, reach the model only when set: the DCANet family
    takes them, the others refuse them (dcanet_tpu/cli.py:70-73)."""
    from dcanet_tpu_torch.parallel import make_disp_constraint
    from dcanet_tpu_torch.train.schedule import epoch_decay_schedule, kitti_finetune_schedule
    from dcanet_tpu_torch.train.state import create_train_state

    dev = resolve_device(device)
    kw = {"remat": True} if cfg.remat else {}
    if mesh is not None and mesh.n_disp > 1:
        kw["constrain_volume"] = make_disp_constraint(mesh)
    model = make_model(cfg.model, maxdisp=cfg.maxdisp, **kw)
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
    metrics and the host time at which they were read). Over processes
    (`parallel.initialize`: one per card) on a (data, disp) grid,
    cfg.batch_size is the global batch over the data axis, the ranks of a
    data row load the same share of it, and the disp ranks split every cost
    volume's planes (cfg.n_disp_shards); only process 0 prints and writes
    logs and checkpoints; every rank returns the same records."""
    from dcanet_tpu_torch.data.loader import Loader, device_prefetch
    from dcanet_tpu_torch.parallel import initialize, make_mesh, process_index, replicate
    from dcanet_tpu_torch.train.checkpoint import CheckpointManager, load_params_only
    from dcanet_tpu_torch.train.loop import LossConfig, train_step
    from dcanet_tpu_torch.utils.experiment import AverageMeterDict, MetricLogger
    from dcanet_tpu_torch.utils.profiling import StepTimer

    dev = initialize(device=resolve_device(device))
    mesh = make_mesh(cfg.n_data_shards, cfg.n_disp_shards)
    if cfg.batch_size % mesh.n_data != 0:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by n_data_shards {mesh.n_data}")
    lead = process_index() == 0
    say = _lead_printer(lead)

    if cfg.dtype == "float32":
        _no_tf32(dev)
    train_ds = build_dataset(cfg, training=True)
    say(f"train samples: {len(train_ds)}")
    loader = Loader(train_ds, cfg.batch_size // mesh.n_data, seed=cfg.seed, num_workers=cfg.num_workers,
                    shard=(mesh.rank, mesh.n_data))
    steps_per_epoch = max(len(loader), 1)
    state = build_train_state(cfg, steps_per_epoch, str(dev), mesh)
    say(f"model params: {sum(p.numel() for p in state.model.parameters()) / 1e6:.2f}M")
    say(f"device: {dev}, dtype {cfg.dtype}")
    say(f"mesh: data={mesh.n_data} disp={mesh.n_disp}")

    ckpt = CheckpointManager(os.path.join(cfg.logdir, "ckpt"))
    if cfg.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        say(f"resumed from step {state.step}")
    elif cfg.loadckpt:
        load_params_only(cfg.loadckpt, state.model)
        say(f"loaded pretrained weights from {cfg.loadckpt}")
    replicate(state.model, mesh)

    loss_cfg = LossConfig(
        max_disp=cfg.maxdisp, focal_coefficient=cfg.focal_coefficient, sparse=cfg.sparse_gt, preset=cfg.loss_preset
    )
    history: List[Dict[str, float]] = []
    log_path = os.path.join(cfg.logdir, "train_log.jsonl")
    timer = StepTimer(cfg.batch_size)
    meters = AverageMeterDict()  # the rows of metrics.jsonl; carried over an epoch's end, as in the JAX CLI
    logger = MetricLogger(cfg.logdir, cfg.use_tensorboard) if lead else None
    with contextlib.closing(logger) if lead else contextlib.nullcontext(), \
            torch.autograd.set_detect_anomaly(cfg.debug_nans):
        for epoch in range(state.step // steps_per_epoch, cfg.epochs):
            loader.set_epoch(epoch)
            timer.reset()
            pending, window = [], []  # metrics stay on the device until printed
            for bi, batch in enumerate(device_prefetch(loader, dev)):
                pending.append((state.step, train_step(state, batch, loss_cfg)))
                timer.tick()
                at_print = (bi + 1) % cfg.print_freq == 0
                if at_print or bi + 1 == steps_per_epoch:
                    now = time.perf_counter()
                    for step, metrics in pending:
                        values = {k: float(v) for k, v in metrics.items()}
                        meters.update(values)
                        rec = {"epoch": epoch, "step": step, **values, "time": now}
                        history.append(rec)
                        window.append(rec)
                    pending = []
                    mean = {k: sum(r[k] for r in window) / len(window) for k in ("total", "epe")}
                    rate = timer.pairs_per_sec
                    say(f"epoch {epoch} step {bi + 1}/{steps_per_epoch} loss {mean['total']:.3f} "
                        f"epe {mean['epe']:.3f} ({rate:.2f} pairs/s)")
                    if lead:
                        with open(log_path, "a") as f:
                            row = {"epoch": epoch, "step": state.step, **mean, "pairs_per_s": rate}
                            f.write(json.dumps(row) + "\n")
                    window = []
                    if at_print:
                        if lead:
                            logger.log(state.step, meters.mean(), prefix="train/")
                        meters.reset()
            if epoch >= cfg.save_after_epoch and (epoch + 1) % cfg.save_every_epochs == 0:
                ckpt.save(state)
    say("training done")
    return history


def _protocol_preset(cfg: RunConfig) -> str:
    """cfg.dataset -> its eval protocol (data/eval_protocol.py)."""
    if cfg.dataset.startswith("kitti"):
        return "kitti"
    if cfg.dataset in ("eth3d", "middlebury", "sceneflow"):
        return cfg.dataset
    return "generic"


def _parse_vis_band(spec: str) -> Tuple[float, float]:
    """'lo:hi' (full-resolution disparities) -> (lo, hi); checked once when
    eval starts, so that a malformed flag fails before any work."""
    parts = spec.split(":")
    try:
        if len(parts) != 2:
            raise ValueError
        lo, hi = float(parts[0]), float(parts[1])
    except ValueError:
        raise SystemExit(
            f"--vis-band must be 'lo:hi' with lo/hi full-resolution disparities (e.g. '39:50'), got {spec!r}"
        ) from None
    if not lo < hi:
        raise SystemExit(f"--vis-band needs lo < hi, got {spec!r}")
    return lo, hi


def cmd_eval(cfg: RunConfig, ckpt: Optional[str] = None, device: Optional[str] = None) -> Dict[str, float]:
    """Score cfg.model on the test split of cfg.dataset (see the module
    docstring); prints and returns the results. With cfg.n_disp_shards > 1
    the processes (`parallel.initialize`) split the cost volumes' disparity
    planes; each returns the same results, and rank 0 alone prints and
    writes. A process group that this command formed is left at its end."""
    import torch.distributed as dist

    from dcanet_tpu_torch.data.eval_protocol import eval_transform
    from dcanet_tpu_torch.parallel import initialize, make_disp_constraint, make_mesh, shutdown
    from dcanet_tpu_torch.train.checkpoint import checkpoint_step
    from dcanet_tpu_torch.train.metrics import disparity_class_confusion, segmentation_scores
    from dcanet_tpu_torch.utils.experiment import AverageMeterDict, MetricLogger

    formed = not dist.is_initialized()
    dev = initialize(device=resolve_device(device))
    mesh = make_mesh(1, cfg.n_disp_shards)
    lead = mesh.disp_rank == 0
    say = _lead_printer(lead)

    vis_band = _parse_vis_band(cfg.vis_band) if cfg.vis_band else None
    ds = build_dataset(cfg, training=False)
    say(f"eval samples: {len(ds)}")
    if mesh.n_disp > 1:
        say(f"eval mesh: disp={mesh.n_disp}")
    path = _newest_checkpoint(ckpt or os.path.join(cfg.logdir, "ckpt"), cfg.seed, say)
    plan = make_disp_constraint(mesh) if mesh.n_disp > 1 else None
    model = build_model(cfg.model, cfg.maxdisp, path, dev, cfg.seed, constrain_volume=plan)
    step = checkpoint_step(path) if path else 0
    say(f"evaluating step {step}")
    bf16 = cfg.dtype == "bfloat16"
    if not bf16:
        _no_tf32(dev)
    protocol = _protocol_preset(cfg)
    meters = AverageMeterDict()
    confusions: List[torch.Tensor] = []  # one per CVA volume
    seconds = []
    logger = MetricLogger(cfg.logdir, cfg.use_tensorboard) if lead else None
    with contextlib.closing(logger) if lead else contextlib.nullcontext():
        for i in range(len(ds)):
            t0 = time.perf_counter()
            left, right, gt, pads = eval_transform(ds[i], protocol)
            with torch.inference_mode():
                tl, tr = (torch.from_numpy(np.ascontiguousarray(x[None])).to(dev) for x in (left, right))
                with torch.autocast(dev.type, torch.bfloat16, enabled=bf16):
                    out = model(tl, tr)
                gt_t = torch.from_numpy(gt).to(dev)
                _eval_one(cfg, i, step, out, gt_t, left, pads, meters, logger, vis_band)
                # every CVA volume is scored (main_dca.py:209-244), on the gt
                # at the model's geometry
                gt_model = F.pad(gt_t, (0, pads[1], pads[0], 0)) if any(pads) else gt_t
                counts = [disparity_class_confusion(lg, gt_model[None], lg.shape[1]) for lg in out.class_logits]
                confusions = [a + c for a, c in zip(confusions, counts)] if confusions else counts
                _sync(dev)
            seconds.append(time.perf_counter() - t0)
        results = meters.mean()
        for vi, conf in enumerate(confusions):
            results.update({f"vol{vi + 1}/{k}": float(v) for k, v in segmentation_scores(conf).items()})
        if confusions:  # the bare keys report the last volume
            results.update({k: float(v) for k, v in segmentation_scores(confusions[-1]).items()})
        if len(seconds) > 1:  # host clock, after the first pair; rank 0's on every rank
            if mesh.n_disp > 1:
                times = torch.tensor(seconds, dtype=torch.float64, device=dev)
                dist.broadcast(times, src=0)
                seconds = times.tolist()
            results["ms_per_pair"] = 1e3 * sum(seconds[1:]) / len(seconds[1:])
            results["pairs_per_s"] = len(seconds[1:]) / sum(seconds[1:])
        if lead:
            logger.log(step, results, prefix="eval/")
    say(str({k: round(v, 4) for k, v in results.items()}))
    if formed:
        shutdown()
    return results


def _eval_one(cfg: RunConfig, i: int, step: int, out, gt: torch.Tensor, left: np.ndarray, pads, meters,
              logger, vis_band) -> None:
    """The per-image metrics of pair i into `meters`, weighted by whether the
    skip rule kept it; its image panels if i < cfg.log_images."""
    from dcanet_tpu_torch.train.metrics import per_image_metrics

    disp = unpad(out.disparity[0].float(), pads)
    mask = (gt > 0) & (gt < cfg.maxdisp)
    m = {k: float(v) for k, v in per_image_metrics(disp[None], gt[None], mask[None]).items()}
    n_valid = int(m.pop("n_valid_images"))
    if n_valid:
        meters.update(m, n=n_valid)
    if logger is not None and i < cfg.log_images:
        _log_panels(cfg, i, step, out, disp.cpu().numpy(), gt.cpu().numpy(), unpad(left, pads), logger, vis_band)


def _log_panels(cfg: RunConfig, i: int, step: int, out, disp: np.ndarray, gt: np.ndarray, left: np.ndarray,
                logger, vis_band) -> None:
    """Pair i's panel (input, estimate, gt and KITTI error map, stacked
    vertically) and one probability-mass heatmap per CVA volume: the mass of
    the disparity band `vis_band` (full-resolution disparities), or of +-1
    class around each pixel's argmax; the generalised counterpart of the
    reference's vis_weight hook (gwcnet_dca_g.py:189-207)."""
    from dcanet_tpu_torch.utils.visualization import disp_error_image

    hi = max(float(gt.max()), 1.0)

    def gray(g):
        return np.repeat(np.clip(g / hi, 0, 1)[..., None], 3, -1)

    raw = left.transpose(1, 2, 0)
    raw = (raw - raw.min()) / max(float(raw.max() - raw.min()), 1e-6)
    logger.log_image(step, f"eval/sample{i}",
                     np.concatenate([raw, gray(disp), gray(gt), disp_error_image(disp, gt)], axis=0))
    for vi, lg in enumerate(out.class_logits):
        prob = lg[0].float().softmax(dim=0).cpu().numpy()
        dcls = np.arange(prob.shape[0])[:, None, None]
        if vis_band is not None:
            scale = cfg.maxdisp / prob.shape[0]  # full-resolution disparity per class
            band = (dcls >= vis_band[0] / scale) & (dcls < vis_band[1] / scale)
        else:
            band = np.abs(dcls - np.argmax(prob, axis=0)[None]) <= 1
        mass = (prob * band).sum(0)
        mass = mass / max(mass.max(), 1e-6)
        logger.log_image(step, f"eval/sample{i}_probmass_vol{vi + 1}", np.repeat(mass[..., None], 3, -1))


_DTYPE_ALIASES = {"f32": "float32", "bf16": "bfloat16"}  # infer's earlier names


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(prog="dcanet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("train", help="train a registry model (default dcanet) with a dataset preset")
    st.add_argument("--preset", default="sceneflow", choices=sorted(PRESETS))
    st.add_argument("--data-root", default=None)
    st.add_argument("--data-root2", default=None)
    st.add_argument("--model", default=None, help="a name of models/registry.py (default: the preset's, dcanet)")
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
    st.add_argument("--n-data-shards", type=int, default=None,
                    help="the data axis; must equal the processes over --n-disp-shards (default: that)")
    st.add_argument("--n-disp-shards", type=int, default=None,
                    help="processes that split the cost volumes' disparity planes (DCANet family; default 1)")
    st.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    se = sub.add_parser("eval", help="EPE / D1 / >1,2,3 px and DCA class scores on a preset's test split")
    se.add_argument("--preset", default="sceneflow", choices=sorted(PRESETS))
    se.add_argument("--dataset", default=None,
                    choices=("sceneflow", "kitti2012", "kitti2015", "kitti_mix", "eth3d", "middlebury"))
    se.add_argument("--data-root", default=None)
    se.add_argument("--data-root2", default=None)
    se.add_argument("--model", default=None, help="a name of models/registry.py (default: the preset's, dcanet)")
    se.add_argument("--maxdisp", type=int, default=None)
    se.add_argument("--dtype", choices=("float32", "bfloat16"), default=None)
    se.add_argument("--logdir", default=None, help="metrics.jsonl/.csv and images/ go here")
    se.add_argument("--ckpt", default=None, help="directory of ckpt_<step>.pt files (default <logdir>/ckpt)")
    se.add_argument("--log-images", type=int, default=None, help="image panels of the first N pairs")
    se.add_argument("--vis-band", default=None,
                    help="full-resolution disparity band 'lo:hi' of the probability-mass panels")
    se.add_argument("--seed", type=int, default=None, help="the reference init's seed, when there is no checkpoint")
    se.add_argument("--n-disp-shards", type=int, default=None,
                    help="processes that split the cost volumes' disparity planes; must equal their number")
    se.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sp = sub.add_parser("infer", help="inference -> uint16 x256 PNG, one pair or a KITTI test list")
    sp.add_argument("--left")
    sp.add_argument("--right")
    sp.add_argument("--out")
    sp.add_argument("--submission", action="store_true",
                    help="my_img.py protocol: per-channel whitening + 384x1248 pad/crop")
    sp.add_argument("--list", default=None,
                    help="KITTI test list, one name per line, read from <data-root>/image_{2,3}/<name> and "
                         "written to <save-path>/<name> with the submission protocol (my_img.py)")
    sp.add_argument("--data-root", default=None)
    sp.add_argument("--save-path", default="./submission")
    src = sp.add_mutually_exclusive_group()
    src.add_argument("--weights", default=None,
                     help=".npz of flax variables, a train checkpoint, an export or a reference torch checkpoint")
    src.add_argument("--logdir", default=None, help="restore the newest DIR/ckpt/ckpt_<step>.pt of `train`")
    sp.add_argument("--model", default="dcanet", help="a name of models/registry.py")
    sp.add_argument("--maxdisp", type=int, default=192)
    sp.add_argument("--dtype", type=lambda v: _DTYPE_ALIASES.get(v, v), choices=("float32", "bfloat16"),
                    default="float32", help="float32 (alias f32) or bfloat16 autocast (alias bf16)")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sx = sub.add_parser("export", help="weights only (for infer --weights, train --loadckpt)")
    sx.add_argument("--logdir", required=True, help="export the newest DIR/ckpt/ckpt_<step>.pt")
    sx.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd in ("train", "eval"):
        skip = ("cmd", "preset", "device", "ckpt")
        overrides = {k: v for k, v in vars(args).items() if k not in skip and v is not None}
        cfg = preset(args.preset, **overrides)
        if args.cmd == "train":
            return cmd_train(cfg, args.device)
        return cmd_eval(cfg, args.ckpt, args.device)
    if args.cmd == "export":
        return cmd_export(args.logdir, args.out)
    if args.list and not args.data_root:
        p.error("infer --list needs --data-root")
    if not args.list and not (args.left and args.right and args.out):
        p.error("infer needs --left, --right and --out, or --list")
    cmd_infer(args)


if __name__ == "__main__":
    from dcanet_tpu_torch.parallel import shutdown

    main()
    shutdown()
