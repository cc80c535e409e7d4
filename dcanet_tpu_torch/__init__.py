"""dcanet_tpu_torch — the PyTorch / CUDA port of dcanet_tpu for NVIDIA Hopper.

Layouts are PyTorch's: images and 2D features NCHW, cost volumes NCDHW.
The JAX package `dcanet_tpu` is the reference this package is held against;
nothing here imports it, JAX or flax.

  ops/      plain tensor ops: cost volumes, soft-argmin, SLC pooling, upsampling
  kernels/  hand-written CUDA kernels (csrc/*.cu), their plain versions,
            dispatchers and launch counters; built with nvcc at first use
  nn/       eval-mode building blocks with the reference's state_dict keys
  models/   DCANet eval forward
  weights.py  flax-variables <-> state_dict bridge, reference checkpoint loader
  data/     PNG IO (numpy + zlib) and the KITTI submission protocol
  cli.py    `python -m dcanet_tpu_torch.cli infer ...`
"""
