"""Cost-volume construction ops (plain PyTorch).

Port of dcanet_tpu/ops/cost_volume.py in PyTorch's channel-first layouts:

    features:     (B, C, H, W)
    cost volume:  (B, C_out, D, H, W)   — NCDHW, D is the disparity axis.

Semantics (the reference's build_gwc_volume / build_concat_volume):
    gwc[b, g, d, h, w]     = mean_{c in group g} L[b,c,h,w] * R[b,c,h,w-d]
    concat[b, :C, d, h, w] = L[b,:,h,w],  concat[b, C:, d, h, w] = R[b,:,h,w-d]
    with zeros for the occluded left margin w < d, and all-zero planes d >= W.

`build_gwc_volume` is the plain version of the CUDA kernel in
`dcanet_tpu_torch/kernels/gwc.py`, which the model calls. Both builders take
`planes=(d_lo, d_hi)`: the planes d_lo <= d < d_hi alone, plane k holding
disparity d_lo + k (the disparity-sharded eval's share of a rank).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dcanet_tpu_torch.ops.precision import at_least_f32

Planes = Optional[Tuple[int, int]]


def plane_range(maxdisp: int, planes: Planes) -> Tuple[int, int]:
    """(d_lo, d_hi) of a volume of `maxdisp` planes, the whole volume for
    None; raises unless 0 <= d_lo < d_hi <= maxdisp."""
    d_lo, d_hi = (0, maxdisp) if planes is None else (int(planes[0]), int(planes[1]))
    if not 0 <= d_lo < d_hi <= maxdisp:
        raise ValueError(f"plane range {planes} not inside [0, {maxdisp})")
    return d_lo, d_hi


def groupwise_correlation(fea1: torch.Tensor, fea2: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-group mean of the elementwise product: (B, C, ...) -> (B, G, ...)."""
    b, c = fea1.shape[:2]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    prod = (fea1 * fea2).reshape(b, num_groups, c // num_groups, *fea1.shape[2:])
    return prod.mean(dim=2)


def build_gwc_volume(
    left: torch.Tensor, right: torch.Tensor, maxdisp: int, num_groups: int, planes: Planes = None
) -> torch.Tensor:
    """Grouped-correlation cost volume, (B, C, H, W) x2 -> (B, G, D, H, W),
    or its planes [d_lo, d_hi) with `planes`.

    Computes in float32 and returns the input dtype, as the CUDA kernel does
    (float64 input, which the kernel refuses, in float64).
    """
    b, c, h, w = left.shape
    d_lo, d_hi = plane_range(maxdisp, planes)
    lf, rf = at_least_f32(left), at_least_f32(right)
    out = torch.zeros((b, num_groups, d_hi - d_lo, h, w), dtype=lf.dtype, device=left.device)
    for d in range(d_lo, min(d_hi, w)):
        out[:, :, d - d_lo, :, d:] = groupwise_correlation(lf[..., d:], rf[..., : w - d], num_groups)
    return out.to(left.dtype)


def build_concat_volume(
    left: torch.Tensor, right: torch.Tensor, maxdisp: int, planes: Planes = None
) -> torch.Tensor:
    """Concatenation cost volume, (B, C, H, W) x2 -> (B, 2C, D, H, W), or its
    planes [d_lo, d_hi) with `planes`: channel block [:C] holds the
    zero-margined left feature, [C:] the d-shifted right feature."""
    b, c, h, w = left.shape
    d_lo, d_hi = plane_range(maxdisp, planes)
    out = left.new_zeros((b, 2 * c, d_hi - d_lo, h, w))
    for d in range(d_lo, min(d_hi, w)):
        out[:, :c, d - d_lo, :, d:] = left[..., d:]
        out[:, c:, d - d_lo, :, d:] = right[..., : w - d]
    return out
