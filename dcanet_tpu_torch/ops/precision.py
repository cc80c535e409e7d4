"""The dtype of the steps that compute in float32 also under bf16 autocast
(softmax over D, BatchNorm statistics, the blends of a disparity): float32
for bf16 and float32 input, float64 for float64 input."""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or as it is when it is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
