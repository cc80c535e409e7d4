"""Run configuration: one dataclass with per-dataset presets (the port's own
copy of dcanet_tpu/config.py). The JAX package's fields for NaN debugging
and mesh sharding wait for the slices that port those paths.

Replaces the reference's per-script argparse duplicates with divergent
defaults (main_dca.py:20-34, train_kitti.py:22-46, train_eth3d.py:23-53,
my_img.py:16-29) and inline magic constants.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunConfig:
    # model
    model: str = "dcanet"
    maxdisp: int = 192
    dtype: str = "float32"  # float32 | bfloat16

    # data
    dataset: str = "sceneflow"  # sceneflow | kitti2012 | kitti2015 | kitti_mix | eth3d | middlebury
    data_root: str = ""
    data_root2: str = ""  # second root for kitti_mix
    batch_size: int = 1
    num_workers: int = 8
    half_res: bool = False

    # schedule
    epochs: int = 40
    base_lr: float = 1e-3
    lr_spec: str = "12,20,24,28:2"  # string-spec decay; "" -> kitti piecewise
    seed: int = 0

    # loss
    loss_preset: str = "sceneflow"  # sceneflow | kitti | smooth_l1
    focal_coefficient: float = 5.0
    sparse_gt: bool = False

    # logging / checkpoints
    logdir: str = "./runs/default"
    save_every_epochs: int = 1
    save_after_epoch: int = 0  # reference: 449 for KITTI, epoch>24 SceneFlow
    print_freq: int = 20
    resume: bool = False
    # weights-only fine-tune init (train.checkpoint.save_params_only): params
    # + BN statistics loaded, optimizer/step fresh — reference
    # train_kitti.py --loadckpt
    loadckpt: str = ""
    # eval image panels (input / estimate / gt / error map, and one
    # probability-mass heatmap per CVA volume) for the first N pairs; 0 = off
    log_images: int = 0
    # full-resolution disparity band "lo:hi" of the probability-mass panels;
    # "" = +-1 class around each pixel's argmax
    vis_band: str = ""
    # mirror MetricLogger's scalars and images to TensorBoard (if it imports)
    use_tensorboard: bool = False
    # checkpoint each CVA block in the train backward (torch.utils.checkpoint):
    # trades recompute for device memory
    remat: bool = False


# Reference-equivalent presets (BASELINE.md "run configurations")
PRESETS = {
    "sceneflow": RunConfig(
        dataset="sceneflow", loss_preset="sceneflow", epochs=40,
        base_lr=1e-3, lr_spec="12,20,24,28:2", batch_size=1,
        logdir="./runs/sceneflow",
    ),
    "kitti": RunConfig(
        dataset="kitti_mix", loss_preset="kitti", sparse_gt=True,
        epochs=1000, base_lr=1e-3, lr_spec="", batch_size=12,
        save_after_epoch=449, logdir="./runs/kitti",
    ),
    "eth3d": RunConfig(
        dataset="eth3d", loss_preset="smooth_l1", epochs=300,
        base_lr=1e-3, lr_spec="12,20,24,28:2", batch_size=1,
        logdir="./runs/eth3d",
    ),
    "middlebury": RunConfig(
        dataset="middlebury", loss_preset="smooth_l1", maxdisp=240,
        epochs=300, base_lr=1e-3, lr_spec="12,20,24,28:2", batch_size=1,
        half_res=True, logdir="./runs/middlebury",
    ),
}


def preset(name: str, **overrides) -> RunConfig:
    cfg = dataclasses.replace(PRESETS[name])
    for k, v in overrides.items():
        if v is not None:
            setattr(cfg, k, v)
    return cfg
