"""Plain PyTorch ops (channel-first layouts)."""

from dcanet_tpu_torch.ops.cost_volume import build_concat_volume, build_gwc_volume, groupwise_correlation
from dcanet_tpu_torch.ops.regression import disparity_regression, softargmin_disparity
from dcanet_tpu_torch.ops.slc import slc_pool
from dcanet_tpu_torch.ops.upsample import convex_upsample, resize_bilinear, resize_trilinear, unfold3x3

__all__ = [
    "build_concat_volume", "build_gwc_volume", "groupwise_correlation",
    "disparity_regression", "softargmin_disparity", "slc_pool", "convex_upsample", "resize_bilinear",
    "resize_trilinear", "unfold3x3",
]
