"""Plain PyTorch DCANet and GwcNet-gc: the benchmark's frozen reference.

Written from the published networks (DCANet, IEEE TIP 2024,
github.com/cocowy1/Cost-Volume-Aggregation-in-Stereo-Matching-Revisited,
models/gwcnet_dca_g.py; GwcNet, Guo et al., CVPR 2019, github.com/xy-guo/GwcNet,
models/gwcnet.py) with nothing but torch operations: no kernel, no cache, no
folding, no sharding. Every tensor is float32 (the caller turns TF32 off).
The state_dict keys are the published networks', so one set of weights
loads into this reference and into the program alike.

Departures from the published code, each what the program under test does
too: DCANet stacks left and right through the feature extractor as one
batch (train-mode BatchNorm takes its statistics over the pair); the
trilinear resizes sample half-pixel centres; GwcNet-gc's hourglasses are
chained without the published residual adds of dres2-4's inputs.

`fp8=True` on a model (`set_fp8`) computes as float8 training does: the
inputs and the weights of every convolution, of every einsum of the
attention and the features of the correlation are rounded to float8 e4m3,
and the gradient arriving at each of their outputs to e5m2 (one scale per
tensor), the products then taken in float32: the precision below bfloat16
that a later change could be tempted to take, used only as the correctness
check's control.

Layouts: images (B, 3, H, W), volumes (B, C, D, H, W), disparities
(B, H, W), probability volumes (B, D, H, W).
"""

from __future__ import annotations

import functools
import importlib
import inspect
import json

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to the float8 `dtype` under one scale (its absolute maximum
    onto the type's largest finite value), back in x's dtype."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3; the gradient passes straight through."""
    return x + (_round(x.detach(), torch.float8_e4m3fn) - x).detach()


class _GradE5M2(torch.autograd.Function):
    """The identity; its gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class _Q:
    fp8 = False

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.fp8 else t

    def qg(self, t: torch.Tensor) -> torch.Tensor:
        return _GradE5M2.apply(t) if self.fp8 and t.requires_grad else t


class Conv2d(_Q, nn.Conv2d):
    def forward(self, x):
        return self.qg(self._conv_forward(self.q(x), self.q(self.weight), self.bias))


class Conv3d(_Q, nn.Conv3d):
    def forward(self, x):
        return self.qg(self._conv_forward(self.q(x), self.q(self.weight), self.bias))


class ConvTranspose2d(_Q, nn.ConvTranspose2d):
    def forward(self, x):
        return self.qg(F.conv_transpose2d(self.q(x), self.q(self.weight), self.bias, self.stride, self.padding,
                                          self.output_padding, self.groups, self.dilation))


class ConvTranspose3d(_Q, nn.ConvTranspose3d):
    def forward(self, x):
        return self.qg(F.conv_transpose3d(self.q(x), self.q(self.weight), self.bias, self.stride, self.padding,
                                          self.output_padding, self.groups, self.dilation))


class _BN:
    """`ends_branch` marks the BatchNorm at the end of a residual branch
    (lib/weights.py draws its scale smaller).

    Train mode: the batch mean and the biased batch variance (the running
    statistics are not kept: nothing the check compares reads them). Eval
    mode: the running statistics. While `calibrating`, eval mode sets the
    running statistics to the input's own first (`calibrate_bn_`)."""

    calibrating = False
    ends_branch = False

    def forward(self, x):
        if self.calibrating:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=[0] + list(range(2, x.dim())), correction=0)
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class BatchNorm2d(_BN, nn.BatchNorm2d):
    pass


class BatchNorm3d(_BN, nn.BatchNorm3d):
    pass


@torch.no_grad()
def calibrate_bn_(model: nn.Module, left: torch.Tensor, right: torch.Tensor) -> nn.Module:
    """Every BatchNorm's running statistics set to its input's mean and
    biased variance in an eval forward of (left, right), layer after layer."""
    norms = [m for m in model.modules() if isinstance(m, _BN)]
    model.eval()
    for m in norms:
        m.calibrating = True
    try:
        model(left, right)
    finally:
        for m in norms:
            m.calibrating = False
    return model


def set_fp8(model: nn.Module, on: bool) -> nn.Module:
    for m in model.modules():
        if isinstance(m, _Q):
            m.fp8 = on
    return model


def convbn(cin, cout, k, stride=1, pad=0, dilation=1, dims=2) -> nn.Sequential:
    conv = (Conv2d if dims == 2 else Conv3d)(cin, cout, k, stride, pad, dilation, bias=False)
    return nn.Sequential(conv, (BatchNorm2d if dims == 2 else BatchNorm3d)(cout))


def ends_branch(seq: nn.Module) -> nn.Module:
    """Mark the last BatchNorm of `seq` as the end of a residual branch."""
    [m for m in seq.modules() if isinstance(m, _BN)][-1].ends_branch = True
    return seq


def convbn_relu(cin, cout, k, stride=1, pad=0, dilation=1, dims=2) -> nn.Sequential:
    return nn.Sequential(convbn(cin, cout, k, stride, pad, dilation, dims), nn.ReLU())


# ---- 2D features (gwcnet_dca_g.py feature_extraction) ----

class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride, dilation):
        super().__init__()
        pad = dilation if dilation > 1 else 1
        self.conv1 = convbn_relu(cin, planes, 3, stride, pad, dilation)
        self.conv2 = ends_branch(convbn(planes, planes, 3, 1, pad, dilation))
        self.downsample = convbn(cin, planes, 1, stride) if stride != 1 or cin != planes else None

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.downsample is None else self.downsample(x))


def _stage(cin, planes, blocks, stride=1, dilation=1):
    return nn.Sequential(BasicBlock(cin, planes, stride, dilation),
                         *[BasicBlock(planes, planes, 1, dilation) for _ in range(blocks - 1)])


class FeatureExtraction(nn.Module):
    def __init__(self, concat_channels: int = 12):
        super().__init__()
        self.firstconv = nn.Sequential(convbn(3, 32, 3, 2, 1), nn.ReLU(), convbn(32, 32, 3, 1, 1), nn.ReLU(),
                                       convbn(32, 32, 3, 1, 1), nn.ReLU())
        self.layer1 = _stage(32, 32, 3)
        self.layer2 = _stage(32, 64, 16, stride=2)
        self.layer3 = _stage(64, 128, 3)
        self.layer4 = _stage(128, 128, 3, dilation=2)
        self.lastconv = nn.Sequential(convbn(320, 128, 3, 1, 1), nn.ReLU(),
                                      Conv2d(128, concat_channels, 1, bias=False))

    def forward(self, x):
        x = self.layer1(self.firstconv(x))
        l2 = self.layer2(x)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        gwc = torch.cat([l2, l3, l4], 1)
        return gwc, self.lastconv(gwc)


# ---- guidance and convex upsampling (submodule.py Guidance, PropgationNet_4x) ----

class ResidualBlock(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1)
        self.norm1, self.norm2 = BatchNorm2d(planes), ends_branch(BatchNorm2d(planes))
        self.downsample = nn.Sequential(Conv2d(cin, planes, 1, stride), BatchNorm2d(planes)) if stride != 1 else None

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        return torch.relu((x if self.downsample is None else self.downsample(x)) + y)


class BasicConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class Guidance(nn.Module):
    def __init__(self, out_dim: int = 64):
        super().__init__()
        self.conv_start = nn.Sequential(Conv2d(3, 32, 7, 2, 3))
        self.norm1 = BatchNorm2d(32)
        self.layer1 = nn.Sequential(ResidualBlock(32, 32, 1), ResidualBlock(32, 32, 1))
        self.layer2 = nn.Sequential(ResidualBlock(32, 64, 2), ResidualBlock(64, 64, 1))
        self.conv_g0 = nn.Sequential(BasicConv(64, 64), BasicConv(64, 64))
        self.guidance = Conv2d(64, out_dim, 3, 1, 1, bias=False)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv_start(x)))
        return self.guidance(self.conv_g0(self.layer2(self.layer1(x))))


def convex_upsample(disp: torch.Tensor, mask_logits: torch.Tensor, s: int) -> torch.Tensor:
    """RAFT's convex 3x3 blend of the coarse disparity (x s) onto an s x s
    grid: mask channel k * s * s + i * s + j, k the row-major neighbour."""
    b, h, w = disp.shape
    mask = mask_logits.view(b, 9, s, s, h, w).softmax(1)
    xp = F.pad(s * disp, (1, 1, 1, 1))
    nb = torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 1)
    up = (mask * nb.view(b, 9, 1, 1, h, w)).sum(1)
    return up.permute(0, 3, 1, 4, 2).reshape(b, h * s, w * s)


class Propagation(nn.Module):
    def __init__(self, c: int = 64, scale: int = 4):
        super().__init__()
        self.scale = scale
        self.conv = nn.Sequential(convbn(c, 2 * c, 3, 1, 1), nn.ReLU(), Conv2d(2 * c, 9 * scale * scale, 3, 1, 1,
                                                                                bias=False))

    def forward(self, guidance, disp):
        return convex_upsample(disp, self.conv(guidance), self.scale)


# ---- cost volumes ----

def gwc_volume(left, right, d: int, groups: int, fp8: bool = False) -> torch.Tensor:
    """gwc[b, g, k, h, w] = mean over group g's channels of L[..., w] * R[..., w - k],
    zero where w < k."""
    if fp8:
        left, right = fp8_round(left), fp8_round(right)
    b, c, h, w = left.shape
    out = left.new_zeros(b, groups, d, h, w)
    for k in range(min(d, w)):
        out[:, :, k, :, k:] = (left[..., k:] * right[..., :w - k]).view(b, groups, c // groups, h, w - k).mean(2)
    return _GradE5M2.apply(out) if fp8 and out.requires_grad else out


def concat_volume(left, right, d: int) -> torch.Tensor:
    b, c, h, w = left.shape
    out = left.new_zeros(b, 2 * c, d, h, w)
    for k in range(min(d, w)):
        out[:, :c, k, :, k:] = left[..., k:]
        out[:, c:, k, :, k:] = right[..., :w - k]
    return out


def trilinear(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, D, H, W) or (B, C, D, H, W) upsampled s x on D, H, W."""
    if x.dim() == 4:
        return trilinear(x[:, None], s)[:, 0]
    return F.interpolate(x, size=tuple(n * s for n in x.shape[2:]), mode="trilinear", align_corners=False)


def regression(prob: torch.Tensor) -> torch.Tensor:
    d = torch.arange(prob.shape[1], dtype=prob.dtype, device=prob.device).view(1, -1, 1, 1)
    return (prob * d).sum(1)


def upsampled_disparity(logits: torch.Tensor, s: int) -> torch.Tensor:
    return regression(trilinear(logits, s).softmax(1))


# ---- 3D aggregation ----

def pre_aggregation(cin: int, c: int):
    dres0 = nn.Sequential(convbn(cin, c, 3, 1, 1, dims=3), nn.ReLU(), convbn(c, c, 3, 1, 1, dims=3), nn.ReLU())
    dres1 = ends_branch(nn.Sequential(convbn(c, c, 3, 1, 1, dims=3), nn.ReLU(), convbn(c, c, 3, 1, 1, dims=3)))
    return dres0, dres1


def classifier(c: int) -> nn.Sequential:
    return nn.Sequential(convbn(c, c, 3, 1, 1, dims=3), nn.ReLU(), Conv3d(c, 1, 3, 1, 1, bias=False))


def deconv_bn(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(ConvTranspose3d(cin, cout, 3, 2, 1, output_padding=1, bias=False), BatchNorm3d(cout))


class MultiAggregation(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = convbn_relu(c, 2 * c, 3, 2, 1, dims=3)
        self.conv2 = convbn_relu(2 * c, 2 * c, 3, 1, 1, dims=3)
        self.conv3 = ends_branch(deconv_bn(2 * c, c))
        self.redir = convbn(c, c, 1, 1, 0, dims=3)

    def forward(self, x, post_residual=None):
        out = torch.relu(self.conv3(self.conv2(self.conv1(x))) + self.redir(x))
        return out if post_residual is None else out + post_residual


class Hourglass(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = convbn_relu(c, 2 * c, 3, 2, 1, dims=3)
        self.conv2 = convbn_relu(2 * c, 2 * c, 3, 1, 1, dims=3)
        self.conv3 = convbn_relu(2 * c, 4 * c, 3, 2, 1, dims=3)
        self.conv4 = convbn_relu(4 * c, 4 * c, 3, 1, 1, dims=3)
        self.conv5 = ends_branch(deconv_bn(4 * c, 2 * c))
        self.conv6 = ends_branch(deconv_bn(2 * c, c))
        self.redir1 = convbn(c, c, 1, 1, 0, dims=3)
        self.redir2 = convbn(2 * c, 2 * c, 1, 1, 0, dims=3)

    def forward(self, x):
        conv2 = self.conv2(self.conv1(x))
        conv5 = torch.relu(self.conv5(self.conv4(self.conv3(conv2))) + self.redir2(conv2))
        return torch.relu(self.conv6(conv5) + self.redir1(x))


def projection(cin: int, cout: int, n: int) -> nn.Sequential:
    blocks = [nn.Sequential(Conv3d(cin if i == 0 else cout, cout, 1, bias=False), BatchNorm3d(cout),
                            nn.LeakyReLU(0.1)) for i in range(n)]
    return blocks[0] if n == 1 else nn.Sequential(*blocks)


class Attention(nn.Module):
    """Per-pixel multi-head cross-attention over D (SelfAttention_bn.py),
    heads of 8 contiguous channels, the query scaled before the product."""

    def __init__(self, c: int, head_dim: int = 8):
        super().__init__()
        self.head_dim = head_dim
        self.query_project = projection(c, c, 2)
        self.key_project = projection(c, c, 2)
        self.value_project = projection(c, c, 1)
        self.out_project = projection(c, c, 1)

    def forward(self, query_feats, key_feats):
        b, c, d, h, w = query_feats.shape
        hd = self.head_dim
        proj = self.out_project[0]
        rnd = proj.q
        q = (self.query_project(query_feats) * hd ** -0.5).view(b, c // hd, hd, d, h, w)
        k = self.key_project(key_feats).view(b, c // hd, hd, d, h, w)
        v = self.value_project(key_feats).view(b, c // hd, hd, d, h, w)
        attn = proj.qg(torch.einsum("bneihw,bnejhw->bnhwij", rnd(q), rnd(k))).softmax(-1)
        ctx = proj.qg(torch.einsum("bnhwij,bnejhw->bneihw", rnd(attn), rnd(v)))
        return self.out_project(ctx.reshape(b, c, d, h, w))


def slc_pool(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Semantic-level context pooling: each pixel's feature at its argmax
    class plane, weighted by its within-class softmax of the class scores."""
    b, c, d, h, w = x.shape
    p = logits.softmax(1)
    s, a = p.amax(1), p.argmax(1)  # the first maximum on ties
    onehot = (a[:, None] == torch.arange(d, device=x.device).view(1, d, 1, 1)).to(x.dtype)  # (B, D, H, W)
    class_max = (onehot * s[:, None]).amax((2, 3))  # (B, D); s > 0, so 0 is the empty class
    e = torch.exp(s - (onehot * class_max[..., None, None]).sum(1))
    class_sum = (onehot * e[:, None]).sum((2, 3))
    weight = e / (onehot * class_sum[..., None, None]).sum(1)
    f = (x * onehot[:, None]).sum(2)
    return onehot[:, None] * (f * weight[:, None])[:, :, None]


class SLC(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.cross_attention = Attention(c)

    def forward(self, x, logits):
        return self.cross_attention(x, slc_pool(x, logits) + x)


class CVA(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.downsample = nn.Sequential(nn.AvgPool3d(3, 2, 1, count_include_pad=True), convbn(c, c, 3, 1, 1, dims=3),
                                        nn.ReLU())
        self.classify = classifier(c)
        self.slc_net = SLC(c)
        self.fuse = nn.Sequential(convbn(2 * c, c, 1, 1, 0, dims=3))
        self.cost_agg = MultiAggregation(c)

    def forward(self, volume, post_residual=None):
        down = self.downsample(volume)
        logits = self.classify(down)[:, 0]
        context = trilinear(self.slc_net(down, logits), 2)
        return logits, self.cost_agg(self.fuse(torch.cat([context, volume], 1)), post_residual)


# ---- the networks ----

def _saved(module: nn.Module, *args):
    """module(*args); in a training forward its activations are recomputed
    in the backward instead of kept (the same operations, so that the
    reference's step fits the card at batch 12)."""
    if module.training and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class DCANet(nn.Module):
    """eval: (disparity (B, H, W), CVA class logits); train: (probability
    volumes, disparities), the ladders the KITTI loss reads."""

    def __init__(self, maxdisp: int = 192, num_cva: int = 3, groups: int = 40, concat_channels: int = 12,
                 base: int = 32):
        super().__init__()
        self.maxdisp, self.num_cva, self.groups = maxdisp, num_cva, groups
        self.feature_extraction = FeatureExtraction(concat_channels)
        self.guidance = Guidance(64)
        self.dres0, self.dres1 = pre_aggregation(groups + 2 * concat_channels, base)
        for i in range(1, num_cva + 1):
            self.add_module(f"cva{i}", CVA(base))
        for i in range(num_cva + 1):
            self.add_module(f"classif{i}", classifier(base))
        self.prop = Propagation(64, 4)

    def forward(self, left, right):
        d4 = self.maxdisp // 4
        b = left.shape[0]
        gwc, cat = self.feature_extraction(torch.cat([left, right], 0))
        guidance = self.guidance(left)
        fp8 = self.prop.conv[2].fp8
        volume = torch.cat([gwc_volume(gwc[:b], gwc[b:], d4, self.groups, fp8),
                            concat_volume(cat[:b], cat[b:], d4)], 1)
        cost0 = _saved(self.dres0, volume)
        cost0 = _saved(self.dres1, cost0) + cost0
        out, outs, logits = cost0, [cost0], []
        for i in range(1, self.num_cva + 1):
            lg, out = _saved(getattr(self, f"cva{i}"), out, cost0 if i == 1 else None)
            logits.append(lg)
            outs.append(out)
        final_prob = getattr(self, f"classif{self.num_cva}")(out)[:, 0].softmax(1)
        disparity = self.prop(guidance, regression(final_prob))
        if not self.training:
            return disparity, logits
        heads = [_saved(getattr(self, f"classif{i}"), outs[i])[:, 0] for i in range(self.num_cva)]
        probs = [heads[0].softmax(1)] + [trilinear(lg, 2).softmax(1) for lg in logits[:self.num_cva - 1]]
        probs += [h.softmax(1) for h in heads[1:]]
        return probs, [upsampled_disparity(logits[-1], 8), disparity]


class GwcNetGC(nn.Module):
    """eval: (disparity, []); train: ([], the four heads' disparities)."""

    def __init__(self, maxdisp: int = 192, groups: int = 40, concat_channels: int = 12, base: int = 32):
        super().__init__()
        self.maxdisp, self.groups = maxdisp, groups
        self.feature_extraction = FeatureExtraction(concat_channels)
        self.dres0, self.dres1 = pre_aggregation(groups + 2 * concat_channels, base)
        self.dres2, self.dres3, self.dres4 = Hourglass(base), Hourglass(base), Hourglass(base)
        for i in range(4):
            self.add_module(f"classif{i}", classifier(base))

    def forward(self, left, right):
        d4 = self.maxdisp // 4
        b = left.shape[0]
        gwc, cat = self.feature_extraction(torch.cat([left, right], 0))
        fp8 = self.classif0[2].fp8
        volume = torch.cat([gwc_volume(gwc[:b], gwc[b:], d4, self.groups, fp8),
                            concat_volume(cat[:b], cat[b:], d4)], 1)
        cost0 = self.dres0(volume)
        cost0 = self.dres1(cost0) + cost0
        out1 = self.dres2(cost0)
        out2 = self.dres3(out1)
        out3 = self.dres4(out2)
        head = lambda i, x: upsampled_disparity(getattr(self, f"classif{i}")(x)[:, 0], 4)  # noqa: E731
        if not self.training:
            return head(3, out3), []
        return [], [head(i, x) for i, x in enumerate((cost0, out1, out2, out3))]


def build(arch: str, **kw) -> nn.Module:
    """The reference network of a configuration's `arch`."""
    nets = {"dcanet": DCANet, "gwcnet-gc": GwcNetGC}
    if arch not in nets:
        raise KeyError(f"no reference for {arch!r}; have {sorted(nets)}")
    return nets[arch](**kw)


# widths a configuration file states that the reference's structure fixes
FIXED_WIDTHS = {"feature_channels": 320, "guidance_channels": 64, "head_dim": 8, "upsample_scale": 4,
                "hourglasses": 3}
# widths a configuration file states, by the reference's argument names
WIDTH_ARGS = {"num_cva": "num_cva", "num_groups": "groups", "concat_channels": "concat_channels",
              "base_channels": "base"}


def from_config(config: dict) -> nn.Module:
    """The reference network of a configuration file (portbench/configs/),
    built with every width the file states; a file that states a width the
    reference fixes otherwise is refused. A file that names a reference
    module (`"reference": "<module>"`) gets that module's network, once the
    module has kept its contract (`named_reference`)."""
    if "reference" in config:
        return named_reference(config)
    for key, width in FIXED_WIDTHS.items():
        if key in config and config[key] != width:
            raise ValueError(f"the configuration states {key} = {config[key]!r}; the reference has {width}")
    kw = {arg: config[key] for key, arg in WIDTH_ARGS.items() if key in config}
    return build(config["arch"], maxdisp=config["maxdisp"], **kw)


# ---- a configuration's own reference module ----

# keys of a configuration file that the harness reads and no reference builds from
HARNESS_KEYS = {"name", "source", "arch", "model", "reference", "program", "maxdisp", "assumed", "layers"}
# the convolutions and BatchNorms that the control (`set_fp8`, TF32) and `calibrate_bn_` reach
KINDS = (Conv2d, Conv3d, ConvTranspose2d, ConvTranspose3d, BatchNorm2d, BatchNorm3d)
_CONV_OR_BN = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d,
               nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d, nn.SyncBatchNorm)
PROBE_SHAPE = (2, 3, 64, 128)  # the pair of the contract's eval forward, on the meta device


def forbidden() -> set:
    """What no reference module may import: what no run may load
    (portbench/run.py), and the port."""
    from portbench.run import FORBIDDEN

    return set(FORBIDDEN) | {"dcanet_tpu_torch"}


def named_reference(config: dict) -> nn.Module:
    """The network of the module portbench/reference/<config["reference"]>.py,
    built by its `from_config(config)`. The module's contract, each breach
    refused with a ValueError that names it:
      - it binds nothing of the port, of the JAX package or of JAX: no module
        and no function or class (imports inside its functions are the
        harness's tests' and each run's own check's to see);
      - it declares `WIDTHS`, the configuration keys it builds from, and may
        declare `FIXED_WIDTHS`, {key: the width its structure fixes}; a file
        that states another key than the harness's own and those, or a fixed
        width at another value, is refused before the module is called;
      - every convolution, transposed convolution and BatchNorm of its
        network is one of this module's own kinds (`KINDS`), which the
        control and `calibrate_bn_` reach;
      - its eval forward of a pair (B, 3, H, W) returns (disparity (B, H, W),
        extras), as the serving driver reads it (run once on the meta device
        at `PROBE_SHAPE`).
    The contract is checked once a process for each module and file."""
    name = config["reference"]
    if not isinstance(name, str) or not name.isidentifier() or name == __name__.rsplit(".", 1)[-1]:
        raise ValueError(f"the configuration's reference {name!r} names no module of portbench/reference/ "
                         f"other than this one")
    module = importlib.import_module(f"{__package__}.{name}")
    _check_contract(name, json.dumps(config, sort_keys=True))
    return module.from_config(config)


@functools.cache
def _check_contract(name: str, config_json: str) -> None:
    module, config = importlib.import_module(f"{__package__}.{name}"), json.loads(config_json)
    owners = (v.__name__ if inspect.ismodule(v) else getattr(v, "__module__", None) for v in vars(module).values())
    found = {owner.split(".")[0] for owner in owners if isinstance(owner, str)} & forbidden()
    if found:
        raise ValueError(f"the reference module {name} imports {sorted(found)}")
    if not callable(getattr(module, "from_config", None)) or not hasattr(module, "WIDTHS"):
        raise ValueError(f"the reference module {name} defines no from_config(config) or no WIDTHS")
    fixed = getattr(module, "FIXED_WIDTHS", {})
    for key in sorted(set(config) - HARNESS_KEYS):
        if key not in module.WIDTHS and key not in fixed:
            raise ValueError(f"the configuration states {key} = {config[key]!r}, which the reference module "
                             f"{name} does not build")
        if key in fixed and config[key] != fixed[key]:
            raise ValueError(f"the configuration states {key} = {config[key]!r}; the reference module {name} "
                             f"has {fixed[key]}")
    with torch.device("meta"):
        probe = module.from_config(config)
        left, right = torch.empty(PROBE_SHAPE), torch.empty(PROBE_SHAPE)
    other = [f"{n} ({type(m).__name__})" for n, m in probe.named_modules()
             if isinstance(m, _CONV_OR_BN) and type(m) not in KINDS]
    if other:
        raise ValueError(f"the reference module {name} builds convolutions or BatchNorms of other kinds than "
                         f"stereo.KINDS: {other[:5]}")
    probe.eval()
    with torch.no_grad():
        out = probe(left, right)
    b, _, h, w = PROBE_SHAPE
    if not (isinstance(out, (tuple, list)) and len(out) == 2 and isinstance(out[0], torch.Tensor)
            and tuple(out[0].shape) == (b, h, w)):
        kind = lambda x: tuple(x.shape) if isinstance(x, torch.Tensor) else type(x).__name__  # noqa: E731
        got = [kind(x) for x in out] if isinstance(out, (tuple, list)) else kind(out)
        raise ValueError(f"the reference module {name}'s eval forward of {PROBE_SHAPE} pairs returns {got!r}, "
                         f"not (disparity {(b, h, w)}, extras)")
