"""dcanet_tpu_torch — the PyTorch / CUDA port of dcanet_tpu for NVIDIA Hopper.

Layouts are PyTorch's: images and 2D features NCHW, cost volumes NCDHW.
The JAX package `dcanet_tpu` is the reference this package is held against;
nothing here imports it, JAX or flax.

  ops/      plain tensor ops: cost volumes, soft-argmin, SLC pooling,
            upsampling, gt probability volumes
  kernels/  hand-written CUDA kernels (csrc/*.cu: the gwc volume and its
            backward, a 3x3x3 conv), their plain versions, dispatchers,
            autograd Functions and launch counters; built with nvcc at first use
  nn/       building blocks with the reference's state_dict keys; train-mode
            BatchNorm with flax's statistics
  models/   DCANet eval and train forwards
  losses.py smooth-L1 and stereo focal losses
  train/    loss presets, train/eval steps, LR schedules, train state,
            checkpoints, metrics
  config.py run presets (sceneflow, kitti, eth3d, middlebury)
  weights.py  flax-variables <-> state_dict bridge, reference checkpoint loader
  data/     PNG/PFM IO (numpy + zlib), the KITTI submission protocol,
            datasets, augmentation, loader with CUDA prefetch, a synthetic
            SceneFlow tree
  cli.py    `python -m dcanet_tpu_torch.cli {train,infer} ...`
"""
