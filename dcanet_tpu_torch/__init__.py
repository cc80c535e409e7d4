"""dcanet_tpu_torch — the PyTorch / CUDA port of dcanet_tpu for NVIDIA Hopper.

Layouts are PyTorch's: images and 2D features NCHW, cost volumes NCDHW.
The JAX package `dcanet_tpu` is the reference this package is held against;
nothing here imports it, JAX or flax.

  ops/      plain tensor ops: cost volumes, soft-argmin, SLC pooling,
            upsampling, gt probability volumes, SGA / LGA aggregation
  kernels/  hand-written CUDA kernels (csrc/*.cu: the gwc volume and its
            backward, a 3x3x3 conv), their plain versions, dispatchers,
            autograd Functions and launch counters; built with nvcc at first use
  nn/       building blocks with the reference's state_dict keys; train-mode
            BatchNorm with flax's statistics; GANet's SGA / LGA blocks
  models/   DCANet, GwcNetBaseline and GANetStereo eval and train forwards;
            the registry of model names
  losses.py smooth-L1 and stereo focal losses, GANet's two losses
  train/    loss presets, train/eval steps, LR schedules, train state,
            checkpoints, metrics (per-image, disparity-class scores)
  config.py run presets (sceneflow, kitti, eth3d, middlebury)
  weights.py  flax-variables <-> state_dict bridge (a key table per model
            family), reference checkpoint loader
  data/     PNG/PFM IO (numpy + zlib), the KITTI submission protocol,
            per-benchmark eval geometry, datasets, list files,
            augmentation, loader with CUDA prefetch, synthetic SceneFlow,
            KITTI 2015 and ETH3D trees, procedural scenes in the SceneFlow
            and KITTI 2012 / 2015 layouts
  utils/    meters, metric logger (JSONL, CSV, PNG panels), error colormap
  cli.py    `python -m dcanet_tpu_torch.cli {train,eval,infer,export} ...`
  traincurve.py  `python -m dcanet_tpu_torch.traincurve`: a training curve
  finetune_kitti.py  `python -m dcanet_tpu_torch.finetune_kitti`: the KITTI
            fine-tune leg (export, eval, train --preset kitti --loadckpt, eval)
"""
