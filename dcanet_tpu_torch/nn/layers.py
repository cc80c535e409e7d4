"""Shared building blocks (port of dcanet_tpu/nn/layers.py).

Layouts are NCHW / NCDHW. Each block is laid out so that its state_dict keys
are the reference's (models/submodule.py):

  ConvBN     = Sequential(Conv{2,3}d(bias=False), BatchNorm{2,3}d)  -> .0 / .1
  ConvBNAct  = Sequential(ConvBN, ReLU)                             -> .0.0 / .0.1

BatchNorm uses eps 1e-5 and torch momentum 0.1 (flax decay 0.9), and in
train mode flax's statistics (see `BatchNorm2d`). The JAX package's TPU
layout paths (folded-BN `epilogue=`, `fold_params`, `packed_out`, kd-fold,
packed dialect, subpixel deconv) are not ported; its `residual=` is a plain
add in the callers.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn
import torch.nn.functional as F

from dcanet_tpu_torch.ops.precision import at_least_f32
from dcanet_tpu_torch.parallel import distributed

_FROZEN = threading.local()


@contextlib.contextmanager
def frozen_bn_statistics():
    """Train-mode BatchNorm inside normalises with batch statistics but leaves
    the running statistics alone. Used for the recomputation of a
    checkpointed block, which would otherwise update them twice per step
    (flax's nn.remat likewise drops the recomputed batch_stats)."""
    depth = getattr(_FROZEN, "depth", 0)
    _FROZEN.depth = depth + 1
    try:
        yield
    finally:
        _FROZEN.depth = depth


class _FlaxStatistics:
    """Train mode as flax's nn.BatchNorm(use_running_average=False): normalise
    with the batch mean and the BIASED batch variance (as F.batch_norm does),
    and update the running variance with that same biased variance, where
    torch's BatchNorm would use the unbiased one (x N/(N-1)). Eval mode is
    torch's, on the running statistics.

    With a process group of more than one rank the statistics are those of
    the global batch (`_global_batch_forward`), as the JAX package's are
    under its data-parallel mesh."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        dims = [0] + list(range(2, x.dim()))
        if distributed.process_count() > 1:
            return self._global_batch_forward(x)
        if x.numel() == x.shape[1]:
            # one value per channel, which F.batch_norm refuses: flax's
            # variance is 0 and the output the bias (a 1x1 pooled map, batch 1)
            var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
            shape = [1, -1] + [1] * (x.dim() - 2)
            y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight.view(shape) + self.bias.view(shape)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if getattr(_FROZEN, "depth", 0) == 0:
            with torch.no_grad():
                var, mean = torch.var_mean(at_least_f32(x.detach()), dim=dims, correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        return y

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the ranks' global batch (`_GlobalBatchNorm`), in
        f32 under bf16 autocast; the running statistics take the global mean
        and biased variance, equal on every rank."""
        y, mean, var = _GlobalBatchNorm.apply(at_least_f32(x), self.weight, self.bias, self.eps)
        if getattr(_FROZEN, "depth", 0) == 0:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the ranks' global batch, in the input's
    dtype (f32 under bf16 autocast, f64 for f64 input).

    Forward, in two passes: the per-channel sums and the count, then the
    centred sum of squares, each summed over the ranks (two all-reduces; no
    E[x^2] - E[x]^2). One value per channel on a rank needs no special
    case. Backward, in the closed form of F.batch_norm's: the per-channel
    sums of dy and dy * xhat summed over the ranks (one all-reduce), so that
    the input gradient holds the other ranks' terms as one process's on the
    whole batch would; the weight and bias gradients are this rank's shares
    (train_step sums them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        sums = distributed.all_reduce_sum(torch.cat([x.sum(dims), x.new_full((1,), x.numel() // x.shape[1])]))
        count = sums[-1]
        mean = sums[:-1] / count
        xc = x - mean.view(shape)
        var = distributed.all_reduce_sum((xc * xc).sum(dims)) / count
        rstd = torch.rsqrt(var + eps)
        xhat = xc * rstd.view(shape)
        ctx.save_for_backward(xhat, weight, rstd, count)
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight.view(shape) + bias.view(shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, rstd, count = ctx.saved_tensors
        dims = [0] + list(range(2, xhat.dim()))
        shape = [1, -1] + [1] * (xhat.dim() - 2)
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        total = distributed.all_reduce_sum(local) / count
        c = weight.numel()
        dx = (dy - total[:c].view(shape) - xhat * total[c:].view(shape)) * (weight * rstd).view(shape)
        return dx, local[c:], local[:c], None


class BatchNorm2d(_FlaxStatistics, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxStatistics, nn.BatchNorm3d):
    pass


def batch_norm(features: int, dims: int) -> nn.Module:
    """BatchNorm{2,3}d with the reference's defaults (eps 1e-5, momentum 0.1)
    and flax's train-mode statistics; nn.BatchNorm{2,3}d's state_dict keys."""
    cls = BatchNorm2d if dims == 2 else BatchNorm3d
    return cls(features, eps=1e-5, momentum=0.1)


def _conv(dims: int):
    return nn.Conv2d if dims == 2 else nn.Conv3d


@torch.no_grad()
def reference_conv_init_(weight: torch.Tensor, generator: torch.Generator, transposed: bool = False) -> torch.Tensor:
    """normal(0, sqrt(2/n)) in place, n = prod(kernel spatial) * out_channels
    (the reference's init loop and kaiming_normal(fan_out, relu)). Conv
    weights are (O, I, *k); transposed-conv weights are (I, O, *k)."""
    out_channels = weight.shape[1] if transposed else weight.shape[0]
    fan_out = math.prod(weight.shape[2:]) * out_channels
    return weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


@torch.no_grad()
def reference_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise a whole module as the JAX package does: reference_conv_init
    for every conv kernel, zero conv biases, identity BatchNorm (weight 1,
    bias 0, running mean 0, running var 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            transposed = isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d))
            reference_conv_init_(m.weight, generator, transposed=transposed)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.reset_parameters()
    return module


class ConvBN(nn.Sequential):
    """Conv (no bias) + BatchNorm, 2D or 3D (reference convbn / convbn_3d)."""

    def __init__(self, in_channels, features, kernel, stride=1, padding=0, dilation=1, dims=2):
        super().__init__(
            _conv(dims)(in_channels, features, kernel, stride, padding, dilation, bias=False),
            batch_norm(features, dims),
        )


class ConvBNAct(nn.Sequential):
    """ConvBN + an activation module without parameters (ReLU unless `act`
    is given)."""

    def __init__(self, in_channels, features, kernel, stride=1, padding=0, dilation=1, dims=2, act=None):
        super().__init__(
            ConvBN(in_channels, features, kernel, stride, padding, dilation, dims),
            nn.ReLU(inplace=True) if act is None else act,
        )


class BasicBlock(nn.Module):
    """Feature-extractor residual block (reference models/submodule.py:251-273):
    convbn+relu, convbn, optional 1x1 conv+BN downsample, residual add with no
    trailing relu. A dilated block pads by its dilation."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, dilation: int = 1, padding: int = 1):
        super().__init__()
        pad = dilation if dilation > 1 else padding
        self.conv1 = ConvBNAct(in_planes, planes, 3, stride, pad, dilation)
        self.conv2 = ConvBN(planes, planes, 3, 1, pad, dilation)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False), batch_norm(planes, 2)
            )

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


class BasicConv(nn.Module):
    """Conv(no bias) + BN + ReLU (reference BasicConv, models/submodule.py:276-302)."""

    def __init__(self, in_channels, features, kernel=3, stride=1, padding=1, dims=2):
        super().__init__()
        self.conv = _conv(dims)(in_channels, features, kernel, stride, padding, bias=False)
        self.bn = batch_norm(features, dims)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class ResidualBlock(nn.Module):
    """Guidance-net residual block, norm_fn='batch' (reference
    models/submodule.py:305-354): conv+BN+relu twice (biased convs), a 1x1
    conv+BN downsample when strided, relu(x + y)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = batch_norm(planes, 2)
        self.norm2 = batch_norm(planes, 2)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride), batch_norm(planes, 2))

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


def torch_conv_transpose3d(in_channels: int, features: int) -> nn.ConvTranspose3d:
    """Exact 2x upsampling transposed conv (kernel 3, stride 2, padding 1,
    output_padding 1): the JAX package's TorchConvTranspose."""
    return nn.ConvTranspose3d(in_channels, features, 3, 2, 1, output_padding=1, bias=False)


def torch_conv_transpose2d(in_channels: int, features: int) -> nn.ConvTranspose2d:
    """The 2D form of `torch_conv_transpose3d`: the JAX package's
    TorchConvTranspose(dims=2)."""
    return nn.ConvTranspose2d(in_channels, features, 3, 2, 1, output_padding=1, bias=False)


def avg_pool3d_torch() -> nn.AvgPool3d:
    """AvgPool3d(3, stride 2, padding 1), count_include_pad=True: the JAX
    package's AvgPool3dTorch."""
    return nn.AvgPool3d(3, 2, 1, count_include_pad=True)


# ---- the ops that mix planes along D, on a rank's slab of a D-sharded volume ----
#
# Each runs the unchanged module's weights on the slab padded along D by
# `shard.halo` (parallel/sharding.py), with no D padding in the call and the
# H/W padding as the module has it. A rank holds the 1/4-resolution planes
# [2 p0, 2 p1) and the half-resolution planes [p0, p1).


def _conv3d_sharded(conv: nn.Conv3d, x: torch.Tensor, shard) -> torch.Tensor:
    """A 3x3x3 pad-1 conv: stride 1 takes one plane each side; stride 2 (out
    plane o reads in planes 2o - 1 .. 2o + 1) one plane below."""
    if conv.kernel_size[0] != 3 or conv.padding[0] != 1 or conv.dilation[0] != 1 or conv.stride[0] not in (1, 2):
        raise ValueError(f"no D-sharded form of {conv}")
    xp = shard.halo(x, 1, 1 if conv.stride[0] == 1 else 0)
    return F.conv3d(xp, conv.weight, conv.bias, conv.stride, (0,) + tuple(conv.padding[1:]), conv.dilation, conv.groups)


def _avg_pool3d_sharded(pool: nn.AvgPool3d, x: torch.Tensor, shard) -> torch.Tensor:
    """AvgPool3d(3, s2, p1), count_include_pad: out plane o averages in planes
    2o - 1 .. 2o + 1, one plane below; the zeros below the volume's first
    plane count in the divisor, as the unsharded padding's do."""
    if (pool.kernel_size, pool.stride, pool.padding, pool.count_include_pad, pool.ceil_mode) != (3, 2, 1, True, False):
        raise ValueError(f"no D-sharded form of {pool}")
    return F.avg_pool3d(shard.halo(x, 1, 0), 3, 2, (0, 1, 1), count_include_pad=True)


def _conv_transpose3d_sharded(deconv: nn.ConvTranspose3d, x: torch.Tensor, shard) -> torch.Tensor:
    """The k3 s2 p1 op1 transposed conv: out planes [2 p0, 2 p1) read in
    planes [p0, p1], one plane above. With no D padding in the call, out
    plane j of the padded slab is global plane 2 p0 + j - 1."""
    if (deconv.kernel_size[0], deconv.stride[0], deconv.padding[0], deconv.output_padding[0]) != (3, 2, 1, 1):
        raise ValueError(f"no D-sharded form of {deconv}")
    y = F.conv_transpose3d(shard.halo(x, 0, 1), deconv.weight, deconv.bias, deconv.stride,
                           (0,) + tuple(deconv.padding[1:]), (0,) + tuple(deconv.output_padding[1:]),
                           deconv.groups, deconv.dilation)
    return y.narrow(2, 1, 2 * x.shape[2])


def run_sharded(module: nn.Module, x: torch.Tensor, shard=None) -> torch.Tensor:
    """module(x), or with a `DispShard` its D-sharded form on this rank's slab:
    Sequentials element by element, the 3x3x3 convs, the CVA's pool and the
    transposed conv on halos; 1x1x1 convs, eval BatchNorm and activations
    are plane-local and run as they are."""
    if shard is None:
        return module(x)
    if isinstance(module, nn.Sequential):
        for m in module:
            x = run_sharded(m, x, shard)
        return x
    if isinstance(module, nn.Conv3d) and module.kernel_size[0] > 1:
        return _conv3d_sharded(module, x, shard)
    if isinstance(module, nn.AvgPool3d):
        return _avg_pool3d_sharded(module, x, shard)
    if isinstance(module, nn.ConvTranspose3d):
        return _conv_transpose3d_sharded(module, x, shard)
    return module(x)
