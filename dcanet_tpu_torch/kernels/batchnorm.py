"""Train-mode BatchNorm with flax's statistics: CUDA kernels, plain version, dispatcher.

The kernels (`dcanet_tpu_torch/csrc/batchnorm.cu`) replace no Pallas kernel:
the JAX package leaves BatchNorm to XLA. They replace PyTorch's own
BatchNorm kernels, which run one block per channel, and the second
statistics pass the plain version makes for the running statistics. Layout
(N, C, *spatial), contiguous channels-first; x f32 or bf16, the statistics,
parameters and running buffers f32.

- `batch_norm_train_reference`: the plain PyTorch version, `F.batch_norm`
  on the batch statistics, then `torch.var_mean` of x (widened to f32) for
  the running statistics, which take flax's BIASED variance; one value per
  channel (which `F.batch_norm` refuses) by hand, flax's output the bias.
- `batch_norm_train_cuda`, `batch_norm_train_backward_cuda`: launch the
  forward kernels (statistics, then the normalisation, which also updates
  the running statistics in place) and the backward kernels on the current
  stream; raise on anything the kernels do not take.
- `batch_norm_train`: differentiable. An f32 or bf16 CUDA x takes
  `BatchNormTrain`, whose forward and backward are the kernels (one value
  per channel too: the kernels' merge gives mean = x and a variance of 0,
  so y is the bias and dx 0, flax's answer); every other x (CPU tensors,
  float64) the plain version. The rule is on x's dtype and device, decided
  before the call: there is no fallback, a CUDA x of those dtypes launches
  or raises.

`LAUNCHES` counts kernel launches (two a forward, two a backward) and
nothing else; `PLAIN_CALLS` the calls `batch_norm_train` sends to the plain
version. `reset_launch_counts` sets both to 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.graph import increment_version

from dcanet_tpu_torch.kernels import build
from dcanet_tpu_torch.ops.precision import at_least_f32

LAUNCHES = 0
PLAIN_CALLS = 0


def reset_launch_counts() -> None:
    global LAUNCHES, PLAIN_CALLS
    LAUNCHES = PLAIN_CALLS = 0


_FUNCS = {torch.float32: ("batchnorm_forward_f32", "batchnorm_backward_f32"),
          torch.bfloat16: ("batchnorm_forward_bf16", "batchnorm_backward_bf16")}
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 9 + [_I, _I, ctypes.c_longlong, _I, ctypes.c_float, ctypes.c_float, _I, _I, _P]
_BWD_ARGS = [_P] * 9 + [_I, _I, ctypes.c_longlong, _I, _I, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load("batchnorm")
    for fwd, bwd in _FUNCS.values():
        for fname, args in ((fwd, _FWD_ARGS), (bwd, _BWD_ARGS)):
            fn = getattr(lib, fname)
            if fn.argtypes is None:
                fn.argtypes = args
                fn.restype = ctypes.c_int
    fn = lib.batchnorm_splits
    if fn.argtypes is None:
        fn.argtypes = [_I, ctypes.c_longlong, _I]
        fn.restype = ctypes.c_int
    return lib


def batch_norm_train_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
    running_var: torch.Tensor, momentum: float, eps: float, update: bool,
) -> torch.Tensor:
    """Train-mode BatchNorm in plain PyTorch: normalised with the batch mean
    and biased variance; with `update`, the running statistics lerped toward
    the batch mean and biased variance by `momentum`."""
    dims = [0] + list(range(2, x.dim()))
    if x.numel() == x.shape[1]:
        # one value per channel, which F.batch_norm refuses: flax's
        # variance is 0 and the output the bias (a 1x1 pooled map, batch 1)
        var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
        shape = [1, -1] + [1] * (x.dim() - 2)
        y = (x - mean) * torch.rsqrt(var + eps) * weight.view(shape) + bias.view(shape)
    else:
        y = F.batch_norm(x, None, None, weight, bias, True, 0.0, eps)
    if update:
        with torch.no_grad():
            var, mean = torch.var_mean(at_least_f32(x.detach()), dim=dims, correction=0)
            running_mean.lerp_(mean, momentum)
            running_var.lerp_(var, momentum)
    return y


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, its data on a 16-byte boundary (a copy otherwise), as
    the kernels' vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _shape(x: torch.Tensor) -> Tuple[int, int, int]:
    n, c = x.shape[0], x.shape[1]
    return n, c, x.numel() // (n * c)


def _check(x: torch.Tensor, *params: Optional[torch.Tensor]) -> None:
    if x.dtype not in _FUNCS:
        raise TypeError(f"batch norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"batch norm kernel needs a CUDA tensor, got one on {x.device}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"batch norm kernel needs a non-empty (N, C, ...) tensor, got {tuple(x.shape)}")
    c = x.shape[1]
    if c > 65535:
        raise ValueError(f"batch norm kernel takes at most 65535 channels, got {c}")
    for p in params:
        if p is None or p.dtype != torch.float32 or p.device != x.device or p.numel() != c or not p.is_contiguous():
            raise ValueError(
                f"batch norm kernel needs contiguous float32 parameters and running statistics of {c} values on "
                f"{x.device}, got {None if p is None else (p.dtype, p.device, tuple(p.shape))}"
            )


def _splits(lib: ctypes.CDLL, c: int, ns: int, device: int) -> int:
    splits = lib.batchnorm_splits(c, ns, device)
    if splits <= 0:
        raise RuntimeError(f"batch norm kernel: no split of {c} channels of {ns} values on device {device}")
    return splits


def batch_norm_train_cuda(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
    running_var: torch.Tensor, momentum: float, eps: float, update: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernels: (y in x's dtype, the batch mean, its invstd), the
    last two f32 vectors of C that the backward takes. With `update` the
    running statistics are updated in place (their version counters too)."""
    global LAUNCHES
    x = _aligned(x)
    _check(x, weight, bias, running_mean, running_var)
    n, c, s = _shape(x)
    lib = _lib()
    dev = x.device.index
    splits = _splits(lib, c, n * s, dev)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    stats = torch.empty(c * (2 + 3 * splits), dtype=torch.float32, device=x.device)
    mean, invstd, partials = stats[:c], stats[c:2 * c], stats[2 * c:]
    err = getattr(lib, _FUNCS[x.dtype][0])(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), mean.data_ptr(), invstd.data_ptr(), partials.data_ptr(),
        n, c, s, splits, eps, momentum, int(update), dev, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"batch norm forward kernels failed to launch with CUDA error {err}")
    LAUNCHES += 2
    if update:
        increment_version((running_mean, running_var))
    return y, mean, invstd


def batch_norm_train_backward_cuda(
    dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels: (dx in x's dtype, dweight, dbias) from the
    output's grad and the forward's x, weight, mean and invstd."""
    global LAUNCHES
    dy, x = _aligned(dy), _aligned(x)
    _check(x, weight, mean, invstd)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"batch norm backward needs a {x.dtype} grad of shape {tuple(x.shape)} on {x.device}, "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    n, c, s = _shape(x)
    lib = _lib()
    dev = x.device.index
    splits = _splits(lib, c, n * s, dev)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    partials = torch.empty(2 * c * splits, dtype=torch.float32, device=x.device)
    err = getattr(lib, _FUNCS[x.dtype][1])(
        dy.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
        dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), partials.data_ptr(),
        n, c, s, splits, dev, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"batch norm backward kernels failed to launch with CUDA error {err}")
    LAUNCHES += 2
    return dx, dweight, dbias


class BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm on a CUDA tensor: forward and backward are the
    kernels; saves x, the weight, the batch mean and invstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum: float, eps: float, update: bool):
        x = _aligned(x)
        y, mean, invstd = batch_norm_train_cuda(x, weight, bias, running_mean, running_var, momentum, eps, update)
        ctx.save_for_backward(x, weight, mean, invstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        dx, dweight, dbias = batch_norm_train_backward_cuda(dy, x, weight, mean, invstd)
        return dx, dweight, dbias, None, None, None, None, None


def batch_norm_train(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
    running_var: torch.Tensor, momentum: float, eps: float, update: bool,
) -> torch.Tensor:
    """Train-mode BatchNorm with flax's statistics, differentiable: the
    kernels for an f32 or bf16 CUDA x, the plain version otherwise (counted
    in `PLAIN_CALLS`)."""
    global PLAIN_CALLS
    if x.device.type == "cuda" and x.dtype in _FUNCS:
        return BatchNormTrain.apply(x, weight, bias, running_mean, running_var, momentum, eps, update)
    PLAIN_CALLS += 1
    return batch_norm_train_reference(x, weight, bias, running_mean, running_var, momentum, eps, update)
