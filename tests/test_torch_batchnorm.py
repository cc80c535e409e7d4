"""Train-mode BatchNorm of the port (dcanet_tpu_torch.kernels.batchnorm).

On the CPU: a numpy emulation of the CUDA kernels' index map and merges
(csrc/batchnorm.cu, its launch shape read from the source) against float64;
the plain version held bit for bit to the arithmetic nn/layers.py ran before
the kernels (F.batch_norm, then var_mean of an f32 copy for the running
statistics); the dispatch rule and its counters.
On the card (`cuda` marker; the kernels have no CPU mode): the kernels
against the plain version and float64, and one traced kitti step. The card's
machine has no JAX: this file imports none and uses no fixture of
tests/conftest.py; there, run:
    python -m pytest --noconftest -m cuda tests/test_torch_batchnorm.py
"""

import copy
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dcanet_tpu_torch.kernels.batchnorm as BN
from dcanet_tpu_torch.kernels import build
from dcanet_tpu_torch.nn.layers import batch_norm, frozen_bn_statistics
from dcanet_tpu_torch.ops.precision import at_least_f32
from dcanet_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHAPE = re.compile(
    r"struct BnShape \{\s*static constexpr int kThreads = (\d+), kBlocksPerSm = (\d+), kUnroll = (\d+), "
    r"kMinSplit = (\d+);"
)


def _launch_shape():
    """(kThreads, kBlocksPerSm, kUnroll, kMinSplit), as csrc/batchnorm.cu sets them."""
    with open(os.path.join(REPO, "dcanet_tpu_torch", "csrc", "batchnorm.cu")) as f:
        found = _SHAPE.findall(f.read())
    assert len(found) == 1, found
    return tuple(int(v) for v in found[0])


THREADS, BLOCKS_PER_SM, UNROLL, MIN_SPLIT = _launch_shape()


def _splits(c, ns, sms):
    """bn_splits: enough blocks per channel to fill BLOCKS_PER_SM on every
    SM, none with fewer than MIN_SPLIT elements, at least one."""
    return min(max(1, sms * BLOCKS_PER_SM // c), max(1, -(-ns // MIN_SPLIT)))


def test_splits_fill_the_card_at_the_kitti_step_shapes():
    # 132 SMs (H100 SXM): the kitti step's 3D and 2D BatchNorms at batch 12
    # take at most one block per slot, and every slot but a few
    slots = 132 * BLOCKS_PER_SM
    for c, ns in ((32, 12 * 48 * 64 * 128), (64, 12 * 24 * 32 * 64), (32, 12 * 24 * 32 * 64), (64, 12 * 64 * 128),
                  (128, 12 * 64 * 128), (32, 12 * 128 * 256)):
        blocks = c * _splits(c, ns, 132)
        assert 0.75 * slots < blocks <= slots, (c, ns, blocks)
    assert _splits(320, 21, 132) == 1 and _splits(1, 10**6, 132) == -(-10**6 // MIN_SPLIT)
    assert _splits(70000, 10**6, 132) == 1


# ---- numpy emulation of csrc/batchnorm.cu ----

f32 = np.float32


def _merge(a, b):
    n = f32(a[0] + b[0])
    if n == 0:
        return a
    d = f32(b[1] - a[1])
    r = f32(b[0] / n)
    mean = f32(np.float64(d) * r + a[1])  # fmaf
    return (n, mean, f32(f32(a[2] + b[2]) + f32(f32(f32(d * d) * a[0]) * r)))


def _run(v):
    mean = f32(np.sum(v, dtype=f32) * f32(1.0 / len(v)))
    dev = (v - mean).astype(f32)
    return (f32(len(v)), mean, f32(np.sum(dev * dev, dtype=f32)))


def _tree(vals, combine, empty):
    """The shuffle tree of a warp (lane i takes lane i + o at o = 16 .. 1),
    then of the warps' results: the block's value."""
    def warp(lanes):
        lanes = list(lanes) + [empty] * (32 - len(lanes))
        o = 16
        while o:
            lanes = [combine(lanes[i], lanes[i + o]) if i + o < 32 else lanes[i] for i in range(32)]
            o //= 2
        return lanes[0]
    warps = [warp(vals[w:w + 32]) for w in range(0, len(vals), 32)]
    return warp(warps)


def _split_start(ns, k, splits, v):
    return ns if k >= splits else ns * k // splits // v * v


def _segments(c, C, S, lo, hi, v):
    """(off, head, nvec, tail) of each row part, as for_each_segment gives them."""
    n = lo // S
    while n * S < hi:
        a, b = max(lo - n * S, 0), min(hi - n * S, S)
        off = (n * C + c) * S + a
        head = min((v - off % v) % v, b - a)
        nvec = (b - a - head) // v
        yield off, head, nvec, b - a - head - nvec * v
        n += 1


def _thread_runs(flat, c, C, S, lo, hi, v, visits):
    """Per thread, the runs it folds in, in its order: each part's head
    element, its vectors t, t + THREADS, ..., its tail element."""
    runs = [[] for _ in range(THREADS)]
    for off, head, nvec, tail in _segments(c, C, S, lo, hi, v):
        for t in range(head):
            runs[t].append(slice(off + t, off + t + 1))
        body = off + head
        for j in range(nvec):
            runs[j % THREADS].append(slice(body + j * v, body + (j + 1) * v))
        for t in range(tail):
            runs[t].append(slice(body + nvec * v + t, body + nvec * v + t + 1))
    for rs in runs:
        for r in rs:
            visits[r] += 1
    return runs


def emulate(x, dy, splits, v):
    """Per channel: the kernels' mean, biased variance, sum of dy and of
    dy * (x - mean) from (N, C, S) float32 arrays, split `splits` ways with
    vectors of v elements; and how often each element was read."""
    N, C, S = x.shape
    ns = N * S
    xf, gf = x.ravel(), dy.ravel()
    visits = np.zeros(xf.size, np.int64)
    out = []
    for c in range(C):
        stats, sums, runs_of = [], [], []
        for k in range(splits):
            lo, hi = _split_start(ns, k, splits, v), _split_start(ns, k + 1, splits, v)
            runs = _thread_runs(xf, c, C, S, lo, hi, v, visits)
            runs_of.append(runs)
            per_thread = []
            for rs in runs:
                m = (f32(0), f32(0), f32(0))
                for r in rs:
                    m = _merge(m, _run(xf[r]) if r.stop - r.start > 1 else (f32(1), xf[r][0], f32(0)))
                per_thread.append(m)
            stats.append(_tree(per_thread, _merge, (f32(0), f32(0), f32(0))))
        lanes = []
        for lane in range(32):
            m = (f32(0), f32(0), f32(0))
            for j in range(lane, splits, 32):
                m = _merge(m, stats[j])
            lanes.append(m)
        n, mean, m2 = _tree(lanes, _merge, (f32(0), f32(0), f32(0)))
        add = lambda a, b: (f32(a[0] + b[0]), f32(a[1] + b[1]))  # noqa: E731
        for runs in runs_of:
            per_thread = []
            for rs in runs:
                s = (f32(0), f32(0))
                for r in rs:
                    for g, xv in zip(gf[r], xf[r]):
                        s = (f32(s[0] + g), f32(np.float64(g) * f32(xv - mean) + s[1]))
                per_thread.append(s)
            sums.append(_tree(per_thread, add, (f32(0), f32(0))))
        lanes = []
        for lane in range(32):
            s = (f32(0), f32(0))
            for j in range(lane, splits, 32):
                s = add(s, sums[j])
            lanes.append(s)
        sdy, sdyx = _tree(lanes, add, (f32(0), f32(0)))
        assert n == ns
        out.append((mean, f32(m2 / n), sdy, sdyx))
    return np.array(out, np.float64), visits


def _bf16_values(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# (N, C, S), element bytes, splits (None: the rule at 132 SMs). S * bytes %
# 16 runs over 0, 2, ..., 14 (bf16) and 0, 4, 8, 12 (f32); ragged shares of
# N*S per split; C = 1, 32, 64, 320; S = 1.
EMULATED = [
    ((3, 1, 1000), 4, 5), ((2, 32, 45), 2, 3), ((2, 64, 9), 4, 2), ((4, 3, 1), 2, 1), ((3, 320, 7), 2, None),
    ((5, 2, 333), 4, 4), ((2, 1, 9000), 2, None), ((1, 2, 20000), 4, None),
] + [((3, 2, s), 2, 2) for s in range(8, 16)] + [((3, 2, s), 4, 3) for s in range(4, 8)]


@pytest.mark.parametrize("shape, elem, splits", EMULATED, ids=[f"{s}-{e}B-{k}" for s, e, k in EMULATED])
def test_emulated_kernels_match_float64(shape, elem, splits):
    rng = np.random.default_rng(sum(shape) + elem)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    dy = (0.5 * x + rng.standard_normal(shape) + 0.3).astype(np.float32)
    if elem == 2:
        x, dy = _bf16_values(x), _bf16_values(dy)
    N, C, S = shape
    splits = splits or _splits(C, N * S, 132)
    got, visits = emulate(x, dy, splits, 16 // elem)
    assert (visits == 1).all(), "every element read exactly once"
    x64, g64 = x.astype(np.float64), dy.astype(np.float64)
    mean = x64.mean(axis=(0, 2))
    var = ((x64 - mean[None, :, None]) ** 2).mean(axis=(0, 2))
    xc = x64 - mean[None, :, None]
    want = np.stack([mean, var, g64.sum(axis=(0, 2)), (g64 * xc).sum(axis=(0, 2))], axis=1)
    # relative to each quantity's own scale: the spread for the mean, the
    # sums of magnitudes for the two backward sums
    scale = np.stack([np.sqrt(mean**2 + var), var, np.abs(g64).sum(axis=(0, 2)), np.abs(g64 * xc).sum(axis=(0, 2))],
                     axis=1)
    np.testing.assert_array_less(np.abs(got - want), 1e-6 * scale + 1e-30)


# ---- the plain version: bit for bit the arithmetic nn/layers.py ran before the kernels ----


def _parent_forward(bn, x, frozen=False):
    """nn/layers.py::_FlaxStatistics.forward's train branch (one process) as
    it stood before the kernels."""
    dims = [0] + list(range(2, x.dim()))
    if x.numel() == x.shape[1]:
        var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
        shape = [1, -1] + [1] * (x.dim() - 2)
        y = (x - mean) * torch.rsqrt(var + bn.eps) * bn.weight.view(shape) + bn.bias.view(shape)
    else:
        y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    if not frozen:
        with torch.no_grad():
            var, mean = torch.var_mean(at_least_f32(x.detach()), dim=dims, correction=0)
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
            bn.num_batches_tracked.add_(1)
    return y


PLAIN_CASES = {  # name: (shape, dtype)
    "2d": ((2, 5, 3, 4), torch.float32),
    "3d": ((2, 4, 3, 5, 6), torch.float32),
    "3d_float64": ((2, 4, 3, 5, 6), torch.float64),
    "2d_two_per_channel": ((2, 3, 1, 1), torch.float32),
    "2d_one_per_channel": ((1, 3, 1, 1), torch.float32),
    "3d_bf16": ((2, 4, 3, 5, 6), torch.bfloat16),
}


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_version_is_the_parent_arithmetic_bit_for_bit(case, frozen):
    shape, dtype = PLAIN_CASES[case]
    gen = torch.Generator().manual_seed(len(case) + frozen)
    mod = batch_norm(shape[1], len(shape) - 2)
    with torch.no_grad():
        mod.weight.uniform_(0.5, 1.5, generator=gen)
        mod.bias.normal_(0.0, 0.1, generator=gen)
        mod.running_mean.normal_(0.0, 0.2, generator=gen)
        mod.running_var.uniform_(0.5, 1.5, generator=gen)
    if dtype == torch.float64:
        mod = mod.double()
    mod.train()
    ref = copy.deepcopy(mod)
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)
    g = torch.randn(shape, generator=gen).to(dtype)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    with frozen_bn_statistics() if frozen else torch.enable_grad():
        ya = mod(xa)
    yb = _parent_forward(ref, xb, frozen)
    assert ya.dtype == yb.dtype and torch.equal(ya, yb)
    ga = torch.autograd.grad(ya, (xa, mod.weight, mod.bias), g)
    gb = torch.autograd.grad(yb, (xb, ref.weight, ref.bias), g)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(mod, name), getattr(ref, name)), name


# ---- the dispatch rule ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_cpu_and_float64_take_the_plain_version_and_are_counted(dtype):
    mod = batch_norm(3, 3).to(dtype if dtype == torch.float64 else torch.float32).train()
    x = torch.randn(2, 3, 2, 3, 4).to(dtype)
    profiling.reset_counters()
    mod(x)
    with frozen_bn_statistics():
        mod(x)
    mod.eval()(x)  # eval mode is torch's own: not counted
    counts = profiling.counters()
    assert counts["bn.plain_calls"] == 2 == BN.PLAIN_CALLS and counts["bn.launches"] == 0
    profiling.reset_counters()
    assert BN.PLAIN_CALLS == 0


def test_one_value_per_channel_on_the_cpu_takes_the_plain_version():
    mod = batch_norm(3, 2).train()
    x = torch.randn(1, 3, 1, 1, requires_grad=True)
    profiling.reset_counters()
    y = mod(x)
    assert BN.PLAIN_CALLS == 1 and BN.LAUNCHES == 0
    assert torch.equal(y, mod.bias.view(1, 3, 1, 1).expand_as(y))
    dx, = torch.autograd.grad(y.sum(), (x,))
    assert torch.equal(dx, torch.zeros_like(dx))
    profiling.reset_counters()


def test_kernel_entry_refuses_what_it_does_not_take_before_building():
    x, p = torch.randn(2, 3, 4), torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        BN.batch_norm_train_cuda(x, p, p, p, p, 0.1, 1e-5, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        BN.batch_norm_train_cuda(x.double(), p, p, p, p, 0.1, 1e-5, True)
    with pytest.raises(ValueError, match="CUDA"):
        BN.batch_norm_train_backward_cuda(x, x, p, p, p)
    assert "batchnorm" not in build._loaded
    assert "batchnorm" in build.KERNELS


# ---- on the card ----

# the kitti step's largest 3D BatchNorm, its most frequent 2D one, a ragged
# S (S * 2 % 16 != 0 in bf16), one channel, a small N*S, one value per
# channel (a 1x1 pooled map at batch 1: y the bias, dx 0)
CUDA_SHAPES = [(12, 32, 48, 64, 128), (12, 64, 64, 128), (2, 5, 3, 7, 9), (3, 1, 1, 17), (2, 3, 2, 2), (1, 3, 1, 1)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _module(c, dims, gen):
    mod = batch_norm(c, dims).cuda().train()
    with torch.no_grad():
        mod.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        mod.bias.copy_(torch.randn(c, generator=gen) * 0.1)
        mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
        mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_version(dtype, frozen):
    _cuda()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    for shape in CUDA_SHAPES:
        c, dims = shape[1], len(shape) - 2
        mod = _module(c, dims, gen)
        ref = copy.deepcopy(mod)
        x = (torch.randn(shape, generator=gen) * 2 + 0.5).cuda().to(dt).requires_grad_()
        g = torch.randn(shape, generator=gen).cuda().to(dt)
        rm0, rv0 = mod.running_mean.clone(), mod.running_var.clone()
        launches, plain = BN.LAUNCHES, BN.PLAIN_CALLS
        with frozen_bn_statistics() if frozen else torch.enable_grad():
            y = mod(x)
        assert (BN.LAUNCHES, BN.PLAIN_CALLS) == (launches + 2, plain)
        dx, dw, db = torch.autograd.grad(y, (x, mod.weight, mod.bias), g)
        assert BN.LAUNCHES == launches + 4 and y.dtype == dx.dtype == dt

        # the statistics against float64 of the same x
        xd = x.detach().double()
        dims_ = [0] + list(range(2, x.dim()))
        mean64 = xd.mean(dims_)
        var64 = xd.var(dims_, correction=0)
        bshape = [1, -1] + [1] * dims
        yk, mean, invstd = BN.batch_norm_train_cuda(x.detach(), mod.weight, mod.bias, rm0.clone(), rv0.clone(), 0.1,
                                                    1e-5, False)
        torch.testing.assert_close(mean.double(), mean64, atol=1e-5 * float(xd.abs().max()), rtol=0)
        torch.testing.assert_close(invstd.double(), torch.rsqrt(var64 + 1e-5), rtol=1e-5, atol=0)
        assert torch.equal(yk, y.detach())
        # the running statistics: flax's lerp toward the biased variance, or
        # left alone under frozen_bn_statistics
        if frozen:
            assert torch.equal(mod.running_mean, rm0) and torch.equal(mod.running_var, rv0)
        else:
            torch.testing.assert_close(mod.running_mean.double(), rm0.double() + 0.1 * (mean64 - rm0.double()),
                                       atol=1e-5 * float(xd.abs().max()), rtol=0)
            torch.testing.assert_close(mod.running_var.double(), rv0.double() + 0.1 * (var64 - rv0.double()),
                                       rtol=1e-5, atol=0)
        # dgamma, dbeta: 1e-4 relative L2 of float64 (the plain version in
        # float64, which takes one value per channel too: dgamma 0 there)
        x64 = xd.clone().requires_grad_()
        w64, b64 = (p.detach().double().requires_grad_() for p in (mod.weight, mod.bias))
        y64 = BN.batch_norm_train_reference(x64, w64, b64, rm0.double(), rv0.double(), 0.1, 1e-5, False)
        dx64, dw64, db64 = torch.autograd.grad(y64, (x64, w64, b64), g.double())
        for got, want in ((dw, dw64), (db, db64)):
            assert float((got.double() - want).norm()) <= 1e-4 * float(want.norm())
        if dt == torch.float32:
            # against the plain version on the card: 1e-5 of its largest value
            xr = x.detach().clone().requires_grad_()
            yr = BN.batch_norm_train_reference(xr, ref.weight, ref.bias, ref.running_mean, ref.running_var, 0.1, 1e-5,
                                               not frozen)
            dxr, = torch.autograd.grad(yr, (xr,), g)
            for got, want in ((y, yr), (dx, dxr)):
                torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
        else:
            # one bf16 ulp of an f32 reference from the kernel's own statistics
            # (2^-7 relative), on 1e-5 of the largest value for f32 rounding
            xf, gf = x.detach().float(), g.float()
            xhat = (xf - mean.view(bshape)) * invstd.view(bshape)
            yr = xhat * mod.weight.view(bshape) + mod.bias.view(bshape)
            n = x.numel() // c
            dxr = (gf - db.view(bshape) / n - xhat * (dw.view(bshape) / n)) * (mod.weight * invstd).view(bshape)
            for got, want in ((y, yr), (dx, dxr)):
                torch.testing.assert_close(got.float(), want, atol=1e-5 * float(want.abs().max()), rtol=2.0**-7)


@pytest.mark.cuda
def test_cuda_kitti_step_runs_every_train_batch_norm_on_the_kernels():
    """One traced kitti-preset bf16 train step (batch 2, 256x512): every
    train-mode BatchNorm of DCANet launches the kernels, two a forward and
    two a backward (each output that the loss reaches: the kitti loss leaves
    classif1's and classif2's out), none takes the plain version."""
    _cuda()
    from torch.profiler import ProfilerActivity, profile

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.train import loop

    cfg = preset("kitti", dtype="bfloat16", maxdisp=192, seed=0)
    state = cli.build_train_state(cfg, 10, "cuda")
    loss_cfg = loop.LossConfig(max_disp=cfg.maxdisp, focal_coefficient=cfg.focal_coefficient, sparse=cfg.sparse_gt,
                               preset=cfg.loss_preset)
    gen = torch.Generator(device="cuda").manual_seed(0)
    left, right = (torch.randn(2, 3, 256, 512, generator=gen, device="cuda") for _ in range(2))
    disp = torch.rand(2, 256, 512, generator=gen, device="cuda") * 150
    batch = {"left": left, "right": right, "disparity": torch.where(disp > 2, disp, torch.zeros_like(disp))}
    calls, grads = [], []

    def count(module, args, out):
        calls.append(1)
        if out.requires_grad:
            out.register_hook(lambda g: grads.append(1))

    hooks = [m.register_forward_hook(count) for m in state.model.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop.train_step(state, batch, loss_cfg)
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    counts = profiling.counters()
    assert len(calls) == 116 and len(grads) == 114
    assert counts["bn.launches"] == 2 * len(calls) + 2 * len(grads) and counts["bn.plain_calls"] == 0
    kernels = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any(k.startswith("void (anonymous namespace)::bn_stats_kernel") or "bn_stats_kernel" in k for k in kernels)
    assert not any("batch_norm_collect_statistics" in k or "batch_norm_backward_kernel" in k for k in kernels)
