"""Group-wise correlation cost volume: CUDA kernels, plain versions, dispatcher.

The kernels (`dcanet_tpu_torch/csrc/gwc.cu`) replace the Pallas TPU kernel
`dcanet_tpu/kernels/gwc.py::_gwc_kernel` and its backward (`_bwd`, XLA
linear transposes there). Layouts: features NCHW (B, C, H, W), volume NCDHW
(B, G, D, H, W); f32 or bf16, accumulated in f32.

- `gwc_volume_reference`: the plain PyTorch version (ops/cost_volume.py);
  `gwc_volume_backward_reference`: autograd through it (of a plane range
  too).
- `gwc_volume_cuda`, `gwc_volume_backward_cuda`: launch the forward and
  backward kernels on the current stream of the tensors' device; raise on
  anything the kernels do not take.
- `gwc_volume`: differentiable. CPU tensors take the plain version (autograd
  through it); CUDA tensors take `GwcVolume`, whose forward and backward are
  the kernels. There is no fallback: a CUDA input either launches the
  kernels or raises.

Every entry takes `planes=(d_lo, d_hi)`: the volume's planes d_lo <= d <
d_hi alone, (B, G, d_hi - d_lo, H, W), plane k holding disparity d_lo + k
(a rank of the disparity-sharded eval and train step builds only its own);
the backward of a range makes that range's part of dL and dR, which the
ranks' parts sum to.

`LAUNCHES` and `BACKWARD_LAUNCHES` count kernel launches and nothing else;
`RANGE_BACKWARD_LAUNCHES` the backward's launches over a part of the planes;
`LAUNCHES_BY_DTYPE` and `BACKWARD_LAUNCHES_BY_DTYPE` the same launches by
the features' dtype ("float32", "bfloat16"). `reset_launch_counts` sets
every count to 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dcanet_tpu_torch.kernels import build
from dcanet_tpu_torch.ops.cost_volume import plane_range
from dcanet_tpu_torch.ops.cost_volume import build_gwc_volume as gwc_volume_reference

LAUNCHES = 0
BACKWARD_LAUNCHES = 0
RANGE_BACKWARD_LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0}
BACKWARD_LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0}


def reset_launch_counts() -> None:
    global LAUNCHES, BACKWARD_LAUNCHES, RANGE_BACKWARD_LAUNCHES
    LAUNCHES = BACKWARD_LAUNCHES = RANGE_BACKWARD_LAUNCHES = 0
    for counts in (LAUNCHES_BY_DTYPE, BACKWARD_LAUNCHES_BY_DTYPE):
        for k in counts:
            counts[k] = 0

_SUPPORTED_CPG = (1, 2, 4, 8, 16, 32)  # channels per group the kernels are built for
_FUNCS = {torch.float32: "gwc_volume_f32", torch.bfloat16: "gwc_volume_bf16"}
_BWD_FUNCS = {torch.float32: "gwc_volume_backward_f32", torch.bfloat16: "gwc_volume_backward_bf16"}


def _lib() -> ctypes.CDLL:
    lib = build.load("gwc")
    for names, n_ptr, n_int in ((_FUNCS, 3, 8), (_BWD_FUNCS, 5, 8)):
        for fname in names.values():
            fn = getattr(lib, fname)
            if fn.argtypes is None:
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
    fn = lib.gwc_volume_backward_smem_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_longlong
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
    left: torch.Tensor, right: torch.Tensor, maxdisp: int, num_groups: int,
    planes: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The CUDA kernel: (B, C, H, W) x2 -> (B, G, d_hi - d_lo, H, W) on the
    features' device; the planes [d_lo, d_hi) of `planes`, all D without."""
    global LAUNCHES
    d_lo, d_hi = plane_range(maxdisp, planes)
    _check(left, right, maxdisp, num_groups)
    b, c, h, w = left.shape
    fn = getattr(_lib(), _FUNCS[left.dtype])
    out = torch.empty((b, num_groups, d_hi - d_lo, h, w), dtype=left.dtype, device=left.device)
    stream = torch.cuda.current_stream(left.device).cuda_stream
    err = fn(
        left.data_ptr(), right.data_ptr(), out.data_ptr(),
        b, c, h, w, num_groups, d_hi - d_lo, d_lo, left.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"gwc kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(left.dtype).removeprefix("torch.")] += 1
    return out


def gwc_volume_backward_cuda(
    grad: torch.Tensor, left: torch.Tensor, right: torch.Tensor, maxdisp: int, num_groups: int,
    planes: Optional[Tuple[int, int]] = None,
):
    """The CUDA backward kernel: the grad of the volume's planes [d_lo, d_hi)
    (B, G, d_hi - d_lo, H, W; all D without `planes`) and the forward's
    features -> their part of (dL, dR), each (B, C, H, W) in the features'
    type."""
    global BACKWARD_LAUNCHES, RANGE_BACKWARD_LAUNCHES
    d_lo, d_hi = plane_range(maxdisp, planes)
    _check(left, right, maxdisp, num_groups)
    b, c, h, w = left.shape
    if grad.shape != (b, num_groups, d_hi - d_lo, h, w) or grad.dtype != left.dtype:
        raise ValueError(
            f"gwc backward needs a {left.dtype} grad of shape {(b, num_groups, d_hi - d_lo, h, w)}, "
            f"got {grad.dtype} {tuple(grad.shape)}"
        )
    if grad.device != left.device or not grad.is_contiguous():
        raise ValueError(f"gwc backward needs a contiguous grad on {left.device}, got {grad.device}")
    lib = _lib()
    fn = getattr(lib, _BWD_FUNCS[left.dtype])
    dleft, dright = torch.empty_like(left), torch.empty_like(right)
    stream = torch.cuda.current_stream(left.device).cuda_stream
    err = fn(
        grad.data_ptr(), left.data_ptr(), right.data_ptr(), dleft.data_ptr(), dright.data_ptr(),
        b, c, h, w, num_groups, d_hi - d_lo, d_lo, left.device.index, stream,
    )
    if err != 0:
        smem = lib.gwc_volume_backward_smem_bytes(c, w, num_groups, d_hi - d_lo, d_lo, left.element_size())
        limit = getattr(torch.cuda.get_device_properties(left.device), "shared_memory_per_block_optin", None)
        raise RuntimeError(
            f"gwc backward kernel launch failed with CUDA error {err}; it asks for {smem} bytes of shared "
            f"memory per block (C/G={c // num_groups}, planes [{d_lo}, {d_hi})), the card allows {limit}"
        )
    BACKWARD_LAUNCHES += 1
    BACKWARD_LAUNCHES_BY_DTYPE[str(left.dtype).removeprefix("torch.")] += 1
    if (d_lo, d_hi) != (0, maxdisp):
        RANGE_BACKWARD_LAUNCHES += 1
    return dleft, dright


def gwc_volume_backward_reference(
    grad: torch.Tensor, left: torch.Tensor, right: torch.Tensor, maxdisp: int, num_groups: int,
    planes: Optional[Tuple[int, int]] = None,
):
    """The plain backward: autograd through `gwc_volume_reference` (of the
    planes [d_lo, d_hi) with `planes`)."""
    with torch.enable_grad():
        l, r = left.detach().requires_grad_(), right.detach().requires_grad_()
        vol = gwc_volume_reference(l, r, maxdisp, num_groups, planes)
        if not vol.requires_grad:  # every plane at or past W: all zeros, whatever the features
            return torch.zeros_like(left), torch.zeros_like(right)
        dleft, dright = torch.autograd.grad(vol, (l, r), grad)
    return dleft, dright


class GwcVolume(torch.autograd.Function):
    """The gwc volume on CUDA tensors, of all planes or of a range: forward
    and backward are the kernels."""

    @staticmethod
    def forward(ctx, left, right, maxdisp: int, num_groups: int, planes=None):
        ctx.save_for_backward(left, right)
        ctx.maxdisp, ctx.num_groups, ctx.planes = maxdisp, num_groups, planes
        return gwc_volume_cuda(left, right, maxdisp, num_groups, planes)

    @staticmethod
    def backward(ctx, grad):
        left, right = ctx.saved_tensors
        dleft, dright = gwc_volume_backward_cuda(
            grad.contiguous(), left, right, ctx.maxdisp, ctx.num_groups, ctx.planes
        )
        return dleft, dright, None, None, None


def gwc_volume(
    left: torch.Tensor, right: torch.Tensor, maxdisp: int, num_groups: int,
    planes: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, G, D, H, W), or its planes [d_lo, d_hi) with
    `planes`, differentiable: the plain version for CPU tensors, the CUDA
    kernels otherwise."""
    if left.device.type == "cpu" and right.device.type == "cpu":
        return gwc_volume_reference(left, right, maxdisp, num_groups, planes)
    return GwcVolume.apply(left, right, maxdisp, num_groups, planes)
