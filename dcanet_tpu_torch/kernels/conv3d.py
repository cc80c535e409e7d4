"""3x3x3 stride-1 pad-1 Conv3D: CUDA kernel, plain version, dispatcher, and
`conv3d_fast`, its autograd form.

The kernels (`dcanet_tpu_torch/csrc/conv3d.cu`) replace the Pallas TPU kernel
`dcanet_tpu/kernels/conv3d.py::_kernel` (launched by `conv3d_pallas`). Both
are implicit GEMMs on the tensor cores with mma.sync: bf16 in one pass, f32
in three TF32 passes (each operand split as hi + lo, both TF32; a*b taken as
hi*hi + hi*lo + lo*hi), which keeps f32 accuracy. Layouts: x and the output
NCDHW (B, C, D, H, W), the weight torch's (Co, C, 3, 3, 3); f32 or bf16,
accumulated in f32; optional per-channel f32 scale and bias, then an
optional ReLU.

- `conv3d_reference`: the plain version, an explicit sum of 27 shifted
  einsums (no cuDNN), in f32, rounded once to the input type.
- `round_tf32`: f32 -> TF32 as cvt.rna.tf32.f32 rounds (the weights' split).
- `pack_weight_tf32x3`, `pack_weight_bf16`: the kernels' weight layouts,
  made once per call.
- `conv3d_cuda`: launches the kernel on the current stream of the tensors'
  device; raises on anything the kernel does not take.
- `conv3d`: the plain version for CPU tensors, the kernel for CUDA tensors;
  no fallback.
- `conv3d_fast(x, w, relu)`: mirrors the JAX package's `conv3d_fast`
  custom_vjp (`conv3d.py:402-435`). Forward: `conv3d`. Backward: the grad is
  masked by `y > 0` under `relu`; dgrad is `conv3d` again, on the grad with
  the weight flipped in (kd, kh, kw) and in/out transposed; wgrad is
  `torch.nn.grad.conv3d_weight` (an XLA conv outside Pallas in the JAX
  package). On CPU tensors the same backward runs on the plain version.

The JAX package's model does not call this kernel (its layers use XLA
convs), and neither does the port's `DCANet`.

`LAUNCHES` counts kernel launches of either type (forward and dgrad) and
nothing else; `BF16_LAUNCHES` those of the bf16 tensor-core kernel alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from dcanet_tpu_torch.kernels import build

LAUNCHES = 0
BF16_LAUNCHES = 0

_FUNCS = {torch.float32: "conv3d_f32", torch.bfloat16: "conv3d_bf16"}
# the kernels' output-channel tile and MMA depths (csrc/conv3d.cu: tc::CO_T,
# tc::CK for bf16, tf32x3::CK for f32)
CO_TILE, C_CHUNK, C_CHUNK_F32 = 32, 16, 8


def _lib() -> ctypes.CDLL:
    lib = build.load("conv3d")
    for fname in _FUNCS.values():
        fn = getattr(lib, fname)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def conv3d_reference(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, relu: bool = False,
) -> torch.Tensor:
    """relu?(conv3d(x, w, pad 1) * scale + bias) as 27 shifted einsums in f32."""
    b, _, d, h, wd = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1, 1, 1))
    wf = w.float()
    out = None
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                tap = torch.einsum(
                    "bcdhw,oc->bodhw", xp[:, :, kd : kd + d, kh : kh + h, kw : kw + wd], wf[:, :, kd, kh, kw]
                )
                out = tap if out is None else out + tap
    if scale is not None:
        out = out * scale.float().view(1, -1, 1, 1, 1)
    if bias is not None:
        out = out + bias.float().view(1, -1, 1, 1, 1)
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype)


def pack_weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """torch's (Co, C, 3, 3, 3) -> the bf16 kernel's (ceil(Co/32), 3 kd,
    ceil(C/16), 9 (kh, kw), 32 co, 16 c), zero-padded in Co and C: one
    kernel step (a kd plane and 16 channels) reads a contiguous 9 x 32 x 16
    slice for its output-channel tile."""
    co, c = w.shape[:2]
    ct, cc = -(-co // CO_TILE), -(-c // C_CHUNK)
    wpad = w.new_zeros((ct * CO_TILE, cc * C_CHUNK, 3, 3, 3))
    wpad[:co, :c] = w
    return (wpad.view(ct, CO_TILE, cc, C_CHUNK, 3, 3, 3).permute(0, 4, 2, 5, 6, 1, 3)
            .reshape(ct, 3, cc, 9, CO_TILE, C_CHUNK).contiguous())


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits) as cvt.rna.tf32.f32: round to nearest
    with ties away from zero, then clear the low 13 bits. Adding half of the
    dropped range to the bits rounds the magnitude; inf and nan pass as they
    are."""
    bits = t.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t.float())


def pack_weight_tf32x3(w: torch.Tensor) -> torch.Tensor:
    """torch's f32 (Co, C, 3, 3, 3) -> the f32 kernel's (ceil(Co/32), 3 kd,
    ceil(C/8), 2, 9 (kh, kw), 32 co, 8 c), zero-padded in Co and C. Index 0
    of the fifth axis holds hi = round_tf32(w), index 1 lo = round_tf32(w - hi):
    both TF32, hi + lo = w within 2^-22 relative. One kernel step (a kd plane
    and 8 channels) reads a contiguous 2 x 9 x 32 x 8 slice for its
    output-channel tile."""
    co, c = w.shape[:2]
    ct, cc = -(-co // CO_TILE), -(-c // C_CHUNK_F32)
    wpad = w.new_zeros((ct * CO_TILE, cc * C_CHUNK_F32, 3, 3, 3), dtype=torch.float32)
    wpad[:co, :c] = w
    hi = round_tf32(wpad)
    parts = torch.stack([hi, round_tf32(wpad - hi)])  # (2, Co', C', 3, 3, 3)
    return (parts.view(2, ct, CO_TILE, cc, C_CHUNK_F32, 3, 3, 3).permute(1, 5, 3, 0, 6, 7, 2, 4)
            .reshape(ct, 3, cc, 2, 9, CO_TILE, C_CHUNK_F32).contiguous())


def _check(x, w, scale, bias) -> None:
    if x.dtype not in _FUNCS or w.dtype != x.dtype:
        raise TypeError(f"conv3d kernel takes float32 or bfloat16 x and w of one type, got {x.dtype} and {w.dtype}")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[1:]) != (x.shape[1], 3, 3, 3):
        raise ValueError(f"conv3d kernel needs x (B, C, D, H, W) and w (Co, C, 3, 3, 3), got {tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("conv3d kernel needs a contiguous NCDHW x")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv3d kernel needs x and w on one CUDA device, got {x.device} and {w.device}")
    if x.shape[0] * x.shape[2] > 65535 or min(x.shape) < 1:
        raise ValueError(f"conv3d kernel takes 1 <= B*D <= 65535, got x {tuple(x.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (w.shape[0],) or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"conv3d kernel needs a contiguous float32 {name} of shape ({w.shape[0]},) on {x.device}")


def conv3d_cuda(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, relu: bool = False,
) -> torch.Tensor:
    """The CUDA kernel: (B, C, D, H, W) x (Co, C, 3, 3, 3) -> (B, Co, D, H, W)."""
    global LAUNCHES, BF16_LAUNCHES
    _check(x, w, scale, bias)
    b, c, d, h, wd = x.shape
    co = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    wt = pack_weight_bf16(w) if bf16 else pack_weight_tf32x3(w)
    out = torch.empty((b, co, d, h, wd), dtype=x.dtype, device=x.device)
    fn = getattr(_lib(), _FUNCS[x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        x.data_ptr(), wt.data_ptr(),
        None if scale is None else scale.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, c, d, h, wd, co, int(bool(relu)), x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"conv3d kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    BF16_LAUNCHES += bf16
    return out


def conv3d(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, relu: bool = False,
) -> torch.Tensor:
    """relu?(conv3d(x, w, pad 1) * scale + bias): the plain version for CPU
    tensors, the CUDA kernel otherwise."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3d_reference(x, w, scale, bias, relu)
    return conv3d_cuda(x, w, scale, bias, relu)


class Conv3dFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, relu: bool):
        y = conv3d(x, w, relu=relu)
        ctx.save_for_backward(x, w, y if relu else None)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, grad):
        x, w, y = ctx.saved_tensors
        if ctx.relu:
            grad = torch.where(y > 0, grad, torch.zeros((), dtype=grad.dtype, device=grad.device))
        grad = grad.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d(grad, w.flip(2, 3, 4).transpose(0, 1).contiguous())
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(x, w.shape, grad, padding=1).to(w.dtype)
        return dx, dw, None


def conv3d_fast(x: torch.Tensor, w: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Differentiable conv3d (no affine; training keeps BN separate): the
    kernel forward, the kernel again for dgrad, a library wgrad."""
    return Conv3dFast.apply(x, w, relu)
