"""Group-wise correlation cost volume: CUDA kernel, plain version, dispatcher.

The kernel (`dcanet_tpu_torch/csrc/gwc.cu`) replaces the Pallas TPU kernel
`dcanet_tpu/kernels/gwc.py::_gwc_kernel`. Layouts: features NCHW
(B, C, H, W), volume NCDHW (B, G, D, H, W); f32 or bf16, accumulated in f32.

- `gwc_volume_reference`: the plain PyTorch version (ops/cost_volume.py).
- `gwc_volume_cuda`: launches the kernel on the current stream of the
  tensors' device; raises on anything the kernel does not take.
- `gwc_volume`: the plain version for CPU tensors, the kernel for CUDA
  tensors. There is no fallback: a CUDA input either launches the kernel or
  raises.

`LAUNCHES` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from dcanet_tpu_torch.kernels import build
from dcanet_tpu_torch.ops.cost_volume import build_gwc_volume as gwc_volume_reference

LAUNCHES = 0

_SUPPORTED_CPG = (1, 2, 4, 8, 16, 32)  # channels per group the kernel is built for
_FUNCS = {torch.float32: "gwc_volume_f32", torch.bfloat16: "gwc_volume_bf16"}


def _lib() -> ctypes.CDLL:
    lib = build.load("gwc")
    for fname in _FUNCS.values():
        fn = getattr(lib, fname)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(left: torch.Tensor, right: torch.Tensor, maxdisp: int, num_groups: int) -> None:
    if left.dtype not in _FUNCS or right.dtype != left.dtype:
        raise TypeError(f"gwc kernel takes float32 or bfloat16 pairs, got {left.dtype} and {right.dtype}")
    if left.dim() != 4 or right.shape != left.shape:
        raise ValueError(f"gwc kernel needs two equal (B, C, H, W) shapes, got {tuple(left.shape)} and {tuple(right.shape)}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("gwc kernel needs contiguous NCHW features")
    c = left.shape[1]
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if c // num_groups not in _SUPPORTED_CPG:
        raise ValueError(f"gwc kernel supports {_SUPPORTED_CPG} channels per group, got {c // num_groups}")
    if maxdisp < 1:
        raise ValueError(f"maxdisp must be >= 1, got {maxdisp}")
    if max(left.shape) >= 2**31:
        raise ValueError(f"shape {tuple(left.shape)} exceeds the kernel's int32 extents")
    if left.device.type != "cuda" or right.device != left.device:
        raise ValueError(
            f"gwc kernel needs both features on one CUDA device, got {left.device} and {right.device}"
        )


def gwc_volume_cuda(
    left: torch.Tensor, right: torch.Tensor, maxdisp: int, num_groups: int
) -> torch.Tensor:
    """The CUDA kernel: (B, C, H, W) x2 -> (B, G, D, H, W) on the features' device."""
    global LAUNCHES
    _check(left, right, maxdisp, num_groups)
    b, c, h, w = left.shape
    fn = getattr(_lib(), _FUNCS[left.dtype])
    out = torch.empty((b, num_groups, maxdisp, h, w), dtype=left.dtype, device=left.device)
    stream = torch.cuda.current_stream(left.device).cuda_stream
    err = fn(
        left.data_ptr(), right.data_ptr(), out.data_ptr(),
        b, c, h, w, num_groups, maxdisp, left.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"gwc kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def gwc_volume(
    left: torch.Tensor, right: torch.Tensor, maxdisp: int, num_groups: int
) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, G, D, H, W): the plain version for CPU tensors,
    the CUDA kernel otherwise."""
    if left.device.type == "cpu" and right.device.type == "cpu":
        return gwc_volume_reference(left, right, maxdisp, num_groups)
    return gwc_volume_cuda(left, right, maxdisp, num_groups)
