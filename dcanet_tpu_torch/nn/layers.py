"""Shared building blocks (port of dcanet_tpu/nn/layers.py).

Layouts are NCHW / NCDHW. Each block is laid out so that its state_dict keys
are the reference's (models/submodule.py):

  ConvBN     = Sequential(Conv{2,3}d(bias=False), BatchNorm{2,3}d)  -> .0 / .1
  ConvBNAct  = Sequential(ConvBN, ReLU)                             -> .0.0 / .0.1

  ConvBNSequential: a Sequential whose (conv, BatchNorm) pairs run through
  `conv_bn` (ConvBN, the deconv + BN pairs of nn/aggregation.py, the
  projections of nn/attention.py)

BatchNorm uses eps 1e-5 and torch momentum 0.1 (flax decay 0.9), and in
train mode flax's statistics (see `BatchNorm2d`). In a bf16 eval the BN of
each site where the JAX package passes `epilogue=bn(..., fold=True)` is
folded into its conv as there (`fold_eval_bn_enabled`, `conv_bn`); at f32
and float64, in train mode and with DCANET_FOLD_EVAL_BN=0 it runs as a
module. Guidance's ResidualBlock and the extras keep their BN, as their
JAX counterparts do. The JAX package's TPU layout paths (`fold_params`,
`packed_out`, kd-fold, packed dialect, subpixel deconv) are not ported;
its `residual=` is a plain add in the callers.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time

import torch
from torch import nn
import torch.nn.functional as F

from dcanet_tpu_torch.ops.precision import at_least_f32, in_model_dtype
from dcanet_tpu_torch.parallel import distributed
from dcanet_tpu_torch.utils import profiling

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


# ---- eval BatchNorm folded into its conv at bf16 (dcanet_tpu/nn/layers.py:48-59, 149-156, 259-262) ----

_CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
FOLD_LOOKUPS = 0  # calls of `_folded`
FOLD_REBUILDS = 0  # folds it computed: cache misses, and every call of the uncached case


def fold_eval_bn_enabled(x: torch.Tensor) -> bool:
    """The JAX package's `fold_eval_bn_enabled`: the compute dtype is bfloat16
    (bf16 autocast on x's device, or a bf16 x) and DCANET_FOLD_EVAL_BN is
    unset or "1", read at each call. f32 and float64 keep the literal BN."""
    dev = x.device.type
    bf16 = x.dtype == torch.bfloat16 or (
        torch.is_autocast_enabled(dev) and torch.get_autocast_dtype(dev) == torch.bfloat16)
    return bf16 and os.environ.get("DCANET_FOLD_EVAL_BN", "1") == "1"


def _fold(conv: nn.Module, bn: nn.Module):
    """(bf16(w * s), bf16(b)) in f32 arithmetic, s = gamma * rsqrt(var + eps)
    along the output channels (dim 0 of a conv's weight, dim 1 of a
    transposed conv's), b = beta - mean * s shaped to add to the output."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * s
    ones = [1] * (conv.weight.dim() - 2)
    axis = [1, -1] if isinstance(conv, (nn.ConvTranspose2d, nn.ConvTranspose3d)) else [-1, 1]
    w = conv.weight.float() * s.view(*axis, *ones)
    return w.to(torch.bfloat16), b.view(1, -1, *ones).to(torch.bfloat16)


def _folded(conv: nn.Module, bn: nn.Module):
    """`_fold(conv, bn)`, cached on `bn` while the five source tensors keep
    their storage (the cache holds them, so an address is not reused) and
    version counter: `load_state_dict`, an optimizer step, an in-place
    change of a statistic and `.to()` each rebuild it. The cached tensors are
    built outside autograd and inference mode. With grad enabled and a
    source requiring it, or a source made in inference mode (no version
    counter), the fold is computed at each call. Counts its calls
    (`FOLD_LOOKUPS`) and the folds it computes (`FOLD_REBUILDS`)."""
    global FOLD_LOOKUPS, FOLD_REBUILDS
    if conv.bias is not None:
        raise ValueError(f"no folded form of a biased {conv}")
    FOLD_LOOKUPS += 1
    src = (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    if any(t.is_inference() for t in src) or (torch.is_grad_enabled() and any(t.requires_grad for t in src)):
        FOLD_REBUILDS += 1
        return _fold(conv, bn)
    key = tuple((t.data_ptr(), t._version) for t in src)
    cache = bn.__dict__.get("_fold_cache")
    if cache is None or cache[0] != key:
        FOLD_REBUILDS += 1
        with torch.inference_mode(False), torch.no_grad():
            w, b = _fold(conv, bn)
        # the detached aliases keep the source storages alive, so that no
        # new tensor can take their addresses while the entry stands
        cache = bn.__dict__["_fold_cache"] = (key, tuple(t.detach() for t in src), w, b)
    return cache[2], cache[3]


def conv_bn(conv: nn.Module, bn: nn.Module, x: torch.Tensor, shard=None) -> torch.Tensor:
    """bn(conv(x)), or with a `DispShard` its D-sharded form on this rank's
    slab. In eval at bf16 (`fold_eval_bn_enabled`) as the JAX package's
    `epilogue=`: one conv with the folded weight (cast to bf16 once, from
    f32), then + b in the output's dtype; the BN module does not run. While
    spans record, the host time of the fold's gate and lookup goes to the
    accumulator `fold.lookup` (utils/profiling.py)."""
    if bn.training:
        return bn(run_sharded(conv, x, shard))
    t0 = time.perf_counter_ns() if profiling.recording() else 0
    if not fold_eval_bn_enabled(x):
        return bn(run_sharded(conv, x, shard))
    w, b = _folded(conv, bn)
    if t0:
        profiling.add_host_time("fold.lookup", t0)
    y = _conv_with_weight(conv, x, w, shard)
    return y + b.to(y.dtype)


class ConvBNSequential(nn.Sequential):
    """A Sequential that starts with a conv and its BatchNorm, which run
    through `conv_bn` (folded in a bf16 eval), then its other children (an
    activation); or a Sequential of such Sequentials. With a `DispShard`,
    each on this rank's slab. nn.Sequential's keys."""

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        mods = list(self)
        if isinstance(mods[0], _CONVS):
            x = conv_bn(mods[0], mods[1], x, shard)
            mods = mods[2:]
        for m in mods:
            x = run_sharded(m, x, shard)
        return x


class ConvBN(ConvBNSequential):
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
            self.downsample = ConvBN(in_planes, planes, 1, stride)

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
        return torch.relu(conv_bn(self.conv, self.bn, x))


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


class AvgPool3dTorch(nn.AvgPool3d):
    """AvgPool3d(3, stride 2, padding 1), count_include_pad=True: the JAX
    package's AvgPool3dTorch; with a `DispShard` on this rank's slab. It
    returns the model's dtype, the mean taken in at least float32 and
    rounded once, with autocast off (ops/precision.py): CPU autocast would
    return float32 (the CPU has no bf16 kernel), CUDA's bf16."""

    def __init__(self):
        super().__init__(3, 2, 1, count_include_pad=True)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        pool = super().forward if shard is None else (lambda t: _avg_pool3d_sharded(self, t, shard))
        return in_model_dtype(lambda t: pool(at_least_f32(t)).to(t.dtype), x)


def avg_pool3d_torch() -> AvgPool3dTorch:
    return AvgPool3dTorch()


# ---- the ops that mix planes along D, on a rank's slab of a D-sharded volume ----
#
# Each runs the unchanged module's weights on the slab padded along D by
# `shard.halo` (parallel/sharding.py), with no D padding in the call and the
# H/W padding as the module has it. A rank holds the 1/4-resolution planes
# [2 p0, 2 p1) and the half-resolution planes [p0, p1).


def _conv3d_sharded(conv: nn.Conv3d, x: torch.Tensor, shard, weight=None) -> torch.Tensor:
    """A 3x3x3 pad-1 conv (with `weight` in place of its own, when given):
    stride 1 takes one plane each side; stride 2 (out plane o reads in
    planes 2o - 1 .. 2o + 1) one plane below."""
    if conv.kernel_size[0] != 3 or conv.padding[0] != 1 or conv.dilation[0] != 1 or conv.stride[0] not in (1, 2):
        raise ValueError(f"no D-sharded form of {conv}")
    xp = shard.halo(x, 1, 1 if conv.stride[0] == 1 else 0)
    return F.conv3d(xp, conv.weight if weight is None else weight, conv.bias, conv.stride,
                    (0,) + tuple(conv.padding[1:]), conv.dilation, conv.groups)


def _avg_pool3d_sharded(pool: nn.AvgPool3d, x: torch.Tensor, shard) -> torch.Tensor:
    """AvgPool3d(3, s2, p1), count_include_pad: out plane o averages in planes
    2o - 1 .. 2o + 1, one plane below; the zeros below the volume's first
    plane count in the divisor, as the unsharded padding's do."""
    if (pool.kernel_size, pool.stride, pool.padding, pool.count_include_pad, pool.ceil_mode) != (3, 2, 1, True, False):
        raise ValueError(f"no D-sharded form of {pool}")
    return F.avg_pool3d(shard.halo(x, 1, 0), 3, 2, (0, 1, 1), count_include_pad=True)


def _conv_transpose3d_sharded(deconv: nn.ConvTranspose3d, x: torch.Tensor, shard, weight=None) -> torch.Tensor:
    """The k3 s2 p1 op1 transposed conv (with `weight` in place of its own,
    when given): out planes [2 p0, 2 p1) read in planes [p0, p1], one plane
    above. With no D padding in the call, out plane j of the padded slab is
    global plane 2 p0 + j - 1."""
    if (deconv.kernel_size[0], deconv.stride[0], deconv.padding[0], deconv.output_padding[0]) != (3, 2, 1, 1):
        raise ValueError(f"no D-sharded form of {deconv}")
    w = deconv.weight if weight is None else weight
    y = F.conv_transpose3d(shard.halo(x, 0, 1), w, deconv.bias, deconv.stride,
                           (0,) + tuple(deconv.padding[1:]), (0,) + tuple(deconv.output_padding[1:]),
                           deconv.groups, deconv.dilation)
    return y.narrow(2, 1, 2 * x.shape[2])


def _conv_with_weight(conv: nn.Module, x: torch.Tensor, weight: torch.Tensor, shard=None) -> torch.Tensor:
    """conv(x) with `weight` in place of its own (a folded one), with a
    `DispShard` on this rank's slab as `run_sharded` runs the conv."""
    if shard is not None and isinstance(conv, nn.Conv3d) and conv.kernel_size[0] > 1:
        return _conv3d_sharded(conv, x, shard, weight)
    if shard is not None and isinstance(conv, nn.ConvTranspose3d):
        return _conv_transpose3d_sharded(conv, x, shard, weight)
    if isinstance(conv, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        fn = F.conv_transpose3d if isinstance(conv, nn.ConvTranspose3d) else F.conv_transpose2d
        return fn(x, weight, conv.bias, conv.stride, conv.padding, conv.output_padding, conv.groups, conv.dilation)
    return conv._conv_forward(x, weight, conv.bias)


def run_sharded(module: nn.Module, x: torch.Tensor, shard=None) -> torch.Tensor:
    """module(x), or with a `DispShard` its D-sharded form on this rank's slab:
    Sequentials element by element (a ConvBNSequential's (conv, BN) pairs
    through `conv_bn`), the 3x3x3 convs, the CVA's pool and the transposed
    conv on halos; 1x1x1 convs, eval BatchNorm and activations are
    plane-local and run as they are."""
    if shard is None:
        return module(x)
    if isinstance(module, ConvBNSequential):
        return module(x, shard)
    if isinstance(module, nn.Sequential):
        for m in module:
            x = run_sharded(m, x, shard)
        return x
    if isinstance(module, nn.Conv3d) and module.kernel_size[0] > 1:
        return _conv3d_sharded(module, x, shard)
    if isinstance(module, AvgPool3dTorch):
        return module(x, shard)
    if isinstance(module, nn.ConvTranspose3d):
        return _conv_transpose3d_sharded(module, x, shard)
    return module(x)
