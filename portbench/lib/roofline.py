"""The yardstick: the H100's published peaks and the gwc kernels' least times.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at its
700 W limit). The bounds count what the gwc volume's arithmetic needs at a
shape: each input byte read once, each output byte written once, a
multiply and an add per channel product of the pairs w >= d, over the f32
rate outside the tensor cores (the kernels compute in f32 for both input
types). They are frozen copies of the bounds the kernel table was measured
against, so that a later change cannot move them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores
TF32_TC_FLOPS = 495e12
BF16_TC_FLOPS = 989e12

# the peak an `mfu` is taken against, by the cell's dtype: float32 with TF32
# off runs on the FMA units
MFU_PEAK = {"float32": F32_FLOPS, "bfloat16": BF16_TC_FLOPS}


def _pairs(w: int, d_lo: int, d_hi: int) -> int:
    return sum(w - d for d in range(d_lo, min(d_hi, w)))


def gwc_bound_ms(shape, groups: int, maxdisp: int, elem_bytes: int) -> float:
    """Least time of the gwc volume of (B, C, H, W) features over `maxdisp`
    planes: both features read once, the volume written once."""
    b, c, h, w = shape
    bytes_moved = (2 * b * c * h * w + b * groups * maxdisp * h * w) * elem_bytes
    ops = 2 * b * c * h * _pairs(w, 0, maxdisp)
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS)


def gwc_backward_bound_ms(shape, groups: int, maxdisp: int, elem_bytes: int) -> float:
    """Least time of the gwc backward: the entries w >= d of the volume's
    gradient, L and R read once, dL and dR written once; a multiply-add per
    channel product for dL and again for dR."""
    b, c, h, w = shape
    pairs = _pairs(w, 0, maxdisp)
    bytes_moved = (4 * b * c * h * w + b * groups * h * pairs) * elem_bytes
    ops = 2 * 2 * b * c * h * pairs
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS)
