"""The dtype plan of the port, in one place.

In a bf16 eval (bf16 autocast, or a bf16 model):
  (a) a tensor that holds a disparity value is float32: the soft-argmin's
      products, its sum and its output, the coarse disparity and the convex
      blend (a bf16 disparity above 128 would round to whole pixels). The
      heads that make the coarse disparity (softmax over D, GwcNet's
      trilinear 4x) stay float32 too: in bf16 they measured further from
      the JAX package's bf16 heads on the CPU than in float32
      (tests/test_torch_bf16_stages.py). ROADMAP Queue 3 item 3 keeps both
      deviations.
  (b) every other tensor is in the dtype the JAX package computes it in,
      the model's dtype: the SLC class pooling, the attention's softmax,
      the CVA's AvgPool3d (its mean taken in float32, rounded once) and its
      trilinear 2x.
  (c) where autocast would pick another dtype on one device than on the
      other (its lists differ: CUDA runs softmax, sum, exp and the upsamples
      in float32, the CPU runs avg_pool3d in float32), the step runs with
      autocast off and an explicit cast (`in_model_dtype`). Autocast then
      decides only the convolutions, transposed convolutions, matmuls and
      einsums of the eval path, which both devices run in bf16
      (tests/test_torch_dtype_plan.py on the CPU; chip_smoke.py holds the
      card's record equal to the CPU's).
At float32 and float64 the plan is the model's dtype throughout. Training
keeps its float32 islands (softmax over D and the soft-argmin of every
ladder, SLC statistics, BatchNorm statistics; `at_least_f32`) and leaves
the attention, the pool and the 2x upsample to autocast.
"""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or as it is when it is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def in_model_dtype(fn, *xs, at_least: torch.dtype = None, enabled: bool = True):
    """fn(*xs) with autocast off on the device of xs[0] and every floating
    tensor of xs cast to the model's dtype there: autocast's dtype where it
    is on, else xs[0]'s own (rules (b) and (c)). `at_least` widens that
    dtype (float32 for rule (a)). With `enabled` False, fn(*xs) as it is."""
    if not enabled:
        return fn(*xs)
    dev = xs[0].device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else xs[0].dtype
    if at_least is not None:
        dtype = torch.promote_types(dtype, at_least)
    with torch.autocast(device_type=dev, enabled=False):
        return fn(*(x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x for x in xs))
