"""The dtype plan of the port, in one place.

In a bf16 eval or train step (bf16 autocast over float32 parameters, or a
bf16 model):
  (a) a tensor that holds a disparity value or a statistic is float32: the
      soft-argmin's products, its sum and its output, the coarse disparity
      and the convex blend (a bf16 disparity above 128 would round to whole
      pixels), BatchNorm's statistics and the gwc volume's sums. The heads
      that make a disparity (softmax over D, the trilinear upsamples before
      it) stay float32 too: in bf16 they measured further from the JAX
      package's bf16 heads on the CPU than in float32
      (tests/test_torch_bf16_stages.py). ROADMAP Queue 3 item 3 keeps these
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
      einsums, which both devices run in bf16
      (tests/test_torch_dtype_plan.py on the CPU; chip_smoke.py holds the
      card's record equal to the CPU's).
Training takes the same plan as eval (tests/test_torch_bf16_train.py holds
a bf16 train step against the JAX package's). It differs in one site: the
SLC pooling takes its statistics (softmax over D, the class maxima and
sums) in float32 from float32 logits, as every ladder's softmax over D and
soft-argmin does, where the eval takes them in bf16. The pooled features
stay in the model's dtype. The backward follows the forward's casts. At
float32 and float64 the plan is the model's dtype throughout
(`at_least_f32` widens, never narrows).
"""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or as it is when it is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def in_model_dtype(fn, *xs, at_least: torch.dtype = None):
    """fn(*xs) with autocast off on the device of xs[0] and every floating
    tensor of xs cast to the model's dtype there: autocast's dtype where it
    is on, else xs[0]'s own (rules (b) and (c)). `at_least` widens that
    dtype (float32 for rule (a))."""
    dev = xs[0].device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else xs[0].dtype
    if at_least is not None:
        dtype = torch.promote_types(dtype, at_least)
    with torch.autocast(device_type=dev, enabled=False):
        return fn(*(x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x for x in xs))
