#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (dcanet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device and build: the card's name and power limit (nvidia-smi); every
     CUDA kernel built from the checkout's sources, one nvcc per source, with
     ptxas's registers, shared memory and spills per kernel; the conv3d library's SASS
     (cuobjdump) must hold only the two tensor-core kernels, with TF32 HMMA
     in the f32 (3xTF32) kernel and bf16 HMMA in the bf16 one.
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the main paths' shapes and at edge cases (for the gwc forward and
     backward: odd W, D = 60, D > W, 1 and 32 channels per group; for the
     forward also the KITTI eval protocol's features, W = 308; for the
     backward also D = 140, 2 and 16 channels per group, 32 on a full tile,
     the Middlebury shape and a batch of 12), TF32
     off: the gwc volume, its backward (against autograd through the plain
     version), conv3d (with scale, bias and ReLU) and conv3d_fast's
     backward; CUDA-event times of kernel, plain version and, for conv3d,
     F.conv3d (cuDNN) beside the card's bound for the same work (the gwc
     forward also at the train and the KITTI eval shape, the backward at
     the train and the Middlebury shape); the gwc kernels
     retimed at the end; for context only, F.conv3d f32 with TF32 on (time,
     and its error, which misses the f32 tolerance).
  3. model: DCANet(num_cva=3, maxdisp=192) eval on one 1x3x384x1248 pair,
     weights from `weights.from_jax_variables` on seeded numpy arrays, in bf16
     autocast and in f32; output shape, finiteness, one gwc launch per forward,
     ms/pair, pairs/s, peak memory; and the GPU model against the CPU model
     (plain gwc) on a small input.
  4. serving: three `cli infer --submission` requests on a synthetic
     KITTI-sized PNG pair; the gwc launches of this phase are counted.
  5. conv3d path: the counterpart of the JAX package's run_pallas
     (tools/bench_conv3d.py), in f32 and in bf16: the convs at its shapes and
     one conv3d_fast forward and backward; the launches of this phase are
     counted for each of the two conv3d kernels.
  6. train: `cli train --preset sceneflow` with DCANet(num_cva=3,
     maxdisp=192) at full width on a synthetic SceneFlow tree (540x960
     pairs from the seed), the preset's 256x512 crop, batch 1, f32: loss
     finite at every step, one gwc forward and one gwc backward launch per
     step (the counts of this phase), ms/step, pairs/s, peak memory, the
     checkpoints, a resumed epoch, and one `cli infer --submission --logdir`
     request served from the run's newest checkpoint (its gwc launch
     counted, its PNG against the checkpoint's weights run in-process); then
     one GPU train step against the CPU train step from the same weights on
     a small input.
  7. eval: `cli eval --preset kitti --dataset kitti2015` with DCANet(num_cva=3,
     maxdisp=192) on a synthetic KITTI 2015 tree of 6 pairs at 375x1242
     (sparse gt, one pair that the per-image skip rule drops), in f32 and in
     bf16, with phase 6's newest checkpoint (the seed-0 init when phase 6
     does not run): one gwc launch per pair (the counts of this phase), EPE,
     D1 and >1/2/3 px against direct model calls with numpy formulas (rel
     1e-5), the class scores of every CVA volume against a numpy count of
     the same logits (exact), `--log-images 2` panels read back; then the
     command again with cuDNN's default algorithms, as a user runs it:
     ms/pair, pairs/s (host clock, after the first pair), peak memory, the
     host's decode of a pair and the forward alone. Then `cli infer --list`
     over 3 names against single `infer --submission` requests, and `cli
     export` of phase 6's run with `infer --weights` on it against `infer
     --logdir`, each bit for bit. The checks that compare two runs take
     cuDNN's deterministic algorithms in both (`cudnn_deterministic`).
  8. summary: the card's name and power limit, one `{"kernels": [...]}` line,
     and last `{"ok": true, "device": {...}}`.

`--phases` runs a subset (for iterating on one part); the summary lines are
printed only for the full run.

Needs CUDA: without a card it exits 1 before printing any result. It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TF32_TC_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense
BF16_TC_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense
SEED = 0
MAIN_SHAPE = (1, 320, 96, 312)  # gwc features of a 384x1248 pair
# gwc features of the KITTI eval protocol's 368x1232 crop: W % 8 != 0, the
# bf16 forward's scalar route
KITTI_EVAL_SHAPE = (1, 320, 92, 308)
TRAIN_SHAPE = (1, 320, 64, 128)  # gwc features of a 256x512 SceneFlow crop
MAIN_GROUPS, MAIN_D = 40, 48
# the gwc backward at the Middlebury preset's 320x704 crop, maxdisp 240
MIDDLEBURY_SHAPE, MIDDLEBURY_D = (1, 320, 80, 176), 60
# the conv3d kernel's own path: tools/bench_conv3d.py::run_pallas's shapes, NCDHW
CONV_SHAPE = (1, 32, 48, 96, 312)
CONV_SHAPE_64 = (1, 64, 48, 96, 312)
# training phase: synthetic SceneFlow pairs at the dataset's 540x960, the
# preset's 256x512 crop, TRAIN_EPOCHS epochs, then one resumed epoch
SCENEFLOW_HW = (540, 960)
TRAIN_PAIRS, TRAIN_EPOCHS, TRAIN_WARMUP = 5, 2, 2
KITTI_HW = (375, 1242)  # a KITTI 2015 image, padded to 384x1248 by --submission
# eval phase: a synthetic KITTI 2015 tree at KITTI_HW, the last pair's gt
# almost all at maxdisp, so that the per-image skip rule drops it
EVAL_PAIRS, EVAL_LIST = 6, ("000000_10.png", "000002_10.png", "000004_10.png")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int = 2, flush=None) -> float:
    """Median ms of `fn` over `iters` launches timed with CUDA events. With
    `flush` (a tensor larger than L2), it is overwritten before every launch
    so that each launch reads its inputs from device memory."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def gwc_bound_ms(shape, groups: int, maxdisp: int, elem_bytes: int):
    """Least time for the gwc volume on an H100: each input read once, the
    volume written once; the products this input needs (w >= d only)."""
    b, c, h, w = shape
    bytes_moved = (2 * b * c * h * w + b * groups * maxdisp * h * w) * elem_bytes
    pairs = sum(w - d for d in range(min(maxdisp, w)))
    ops = 2 * b * c * h * pairs  # a multiply and an add per channel product
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from dcanet_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    log(f"[build] {len(report)} kernel(s) in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.2f} s -> {r['path']}")
        for line in r["log"].splitlines():
            if any(k in line for k in ("entry function", "registers", "smem", "spill")):
                log(f"[build]   {line.strip()}")
    check_tensor_cores(report["conv3d"]["path"])


def check_tensor_cores(lib_path: str) -> None:
    """The conv3d library's SASS (cuobjdump): HMMA instructions per kernel;
    raises unless the library holds only the f32 (3xTF32) and the bf16
    kernels, every HMMA of the f32 ones is TF32 and of the bf16 ones BF16,
    and each has some."""
    from dcanet_tpu_torch.kernels import build

    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    hmma, first, fn = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            hmma[fn] = []
        elif fn is not None and "HMMA" in line:
            hmma[fn].append(line.split("HMMA", 1)[1].split()[0])  # e.g. ".1684.F32.TF32"
            first.setdefault(fn, " ".join(line.split()))
    for fn, ops in hmma.items():
        log(f"[build] SASS {fn}: {len(ops)} HMMA {sorted(set(ops))}" + (f", first: {first[fn]}" if ops else ""))
    want = {"conv3d_tf32x3_kernel": ".TF32", "conv3d_bf16_kernel": ".BF16"}  # x2: with and without ReLU
    bad = []
    for fn, ops in hmma.items():
        types = [t for k, t in want.items() if k in fn]
        if len(types) != 1 or not ops or not all(op.endswith(types[0]) for op in ops):
            bad.append(fn)
    if bad or len(hmma) != 4:
        raise AssertionError(f"[build] conv3d SASS: expected 2 TF32 and 2 BF16 tensor-core kernels, got "
                             f"{ {fn: sorted(set(ops)) for fn, ops in hmma.items()} }")


def check_close(tag: str, got, want, atol: float, rtol: float) -> float:
    """max |got - want|; raises if any element lies outside atol + rtol*|want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"[kernels] {tag}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    err = (got.float() - want.float()).abs()
    bad = int((err > atol + rtol * want.float().abs()).sum())
    max_err = float(err.max())
    log(f"[kernels] {tag}: max|err| {max_err:.3e} (atol {atol:.3g}, rtol {rtol:g}), {bad} elements outside")
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {tag}")
    return max_err


def gwc_backward_bound_ms(shape, groups: int, maxdisp: int, elem_bytes: int):
    """Least time for the gwc backward: the entries w >= d of the volume's
    grad (the occluded w < d reach neither dL nor dR), L and R read once, dL
    and dR written once; a multiply-add per channel product this input
    needs, for dL and again for dR."""
    b, c, h, w = shape
    pairs = sum(w - d for d in range(min(maxdisp, w)))
    bytes_moved = (4 * b * c * h * w + b * groups * h * pairs) * elem_bytes
    ops = 2 * 2 * b * c * h * pairs
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv3d_bound_ms(x_shape, co: int, elem_bytes: int, fma: bool = False):
    """Least time for a 3x3x3 conv: x and the weight read once, the output
    written once; 2*27*C*Co operations per output point at the dense
    tensor-core rate, for f32 three TF32 passes (3xTF32, the f32 kernel's
    arithmetic), or with `fma` at the f32 rate outside the tensor cores."""
    b, c, d, h, w = x_shape
    n = b * d * h * w
    bytes_moved = (n * (c + co) + 27 * c * co) * elem_bytes
    ops = 2 * 27 * c * co * n
    if elem_bytes == 2:
        peak = BF16_TC_FLOPS
    else:
        peak = F32_FLOPS if fma else TF32_TC_FLOPS / 3
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_tf32(x, w, flush) -> dict:
    """For context only: F.conv3d on f32 with TF32 on (cuDNN's default), its
    time and its error against the plain version, which misses the f32
    tolerance 1e-5 * max(1, max|ref|); TF32 is off again afterwards."""
    import torch
    import torch.nn.functional as F

    from dcanet_tpu_torch.kernels import conv3d as cv

    torch.backends.cudnn.allow_tf32 = True
    try:
        ms = time_cuda(lambda: F.conv3d(x, w, padding=1), 10, flush=flush)
        got = F.conv3d(x, w, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = cv.conv3d_reference(x, w)
    err = float((got - want).abs().max())
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    log(f"[kernels] context: F.conv3d f32 with TF32 on x{tuple(x.shape)}: {ms:.4f} ms, max|err| vs plain "
        f"{err:.3e}, {err / atol:.1f}x the f32 tolerance {atol:.3g}")
    return dict(ms=ms, max_abs_err=err, tolerance=atol)


def _gwc_backward_plain(left, right, grad, d, groups):
    """The plain backward's graph, built once: autograd through the plain
    forward; the returned closure runs its backward only."""
    import torch

    from dcanet_tpu_torch.kernels import gwc

    l, r = left.detach().requires_grad_(), right.detach().requires_grad_()
    vol = gwc.gwc_volume_reference(l, r, d, groups)
    return lambda: torch.autograd.grad(vol, (l, r), grad, retain_graph=True)


def phase_kernels():
    """Each kernel vs its plain version; returns the numbers for the kernels line."""
    import torch
    import torch.nn.functional as F

    from dcanet_tpu_torch.kernels import conv3d as cv
    from dcanet_tpu_torch.kernels import gwc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    # gwc, f32: the kernel and the plain version differ only in summation
    # order. bf16: both sum in f32 and round once to bf16, so they differ by
    # at most one bf16 ulp (2^-7 relative).
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0**-7)}
    cases = [
        ("main f32", MAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("main bf16", MAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("kitti eval f32", KITTI_EVAL_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("kitti eval bf16", KITTI_EVAL_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train f32", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train bf16", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("D=60 f32", MAIN_SHAPE, MAIN_GROUPS, 60, torch.float32),
        ("D=60 bf16", MAIN_SHAPE, MAIN_GROUPS, 60, torch.bfloat16),
        ("D>W f32", (2, 16, 5, 7), 4, 12, torch.float32),
        ("D>W bf16", (2, 16, 5, 7), 4, 12, torch.bfloat16),
        # the forward kernel's edges: odd W (scalar loads and stores), one
        # channel per group with D > its 128-column tile (three passes over
        # d), 32 channels per group with W % 8 != 0 on two tiles
        ("odd W f32", (1, 16, 5, 45), 4, 60, torch.float32),
        ("odd W bf16", (1, 16, 5, 45), 4, 60, torch.bfloat16),
        ("CPG=1 f32", (2, 8, 2, 150), 8, 140, torch.float32),
        ("CPG=1 bf16", (2, 8, 2, 150), 8, 140, torch.bfloat16),
        ("CPG=32 f32", (1, 64, 3, 130), 2, 48, torch.float32),
        ("CPG=32 bf16", (1, 64, 3, 130), 2, 48, torch.bfloat16),
    ]
    errs = {}
    for name, shape, groups, d, dtype in cases:
        left, right = randn(shape, dtype), randn(shape, dtype)
        got = gwc.gwc_volume_cuda(left, right, d, groups)
        want = gwc.gwc_volume_reference(left, right, d, groups)
        torch.cuda.synchronize()
        errs[name] = check_close(f"gwc {name} {tuple(shape)} G={groups} D={d}", got, want, *tol[dtype])

    # gwc backward against autograd through the plain version, grad at unit
    # scale. f32: sums of up to D products (no mean over the channels where
    # one channel makes a group) in another order, so the tolerance scales
    # with the output's magnitude as conv3d's does: 1e-5 * max(1, max|ref|);
    # bf16: one ulp on top, both round once from f32.
    def bwd_tol(dtype, ref):
        return 1e-5 * max(1.0, float(ref.float().abs().max())), tol[dtype][1]

    bwd_cases = [
        ("train f32", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train bf16", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("D>W f32", (2, 16, 5, 7), 4, 12, torch.float32),
        ("D>W bf16", (2, 16, 5, 7), 4, 12, torch.bfloat16),
        # the backward kernel's edges: odd W (scalar loads and stores), one
        # channel per group with D = 140 > its 64-disparity pass (three
        # passes, the later ones staged once for dL and once for dR), 32
        # channels per group on two ragged tiles and on one full 128-column
        # tile (f32: one thread per set of sums, 512 threads), 2 and 16
        # channels per group; the Middlebury train shape (three tiles of 64,
        # D = 60) and the KITTI preset's batch of 12
        ("odd W f32", (1, 16, 5, 45), 4, 60, torch.float32),
        ("odd W bf16", (1, 16, 5, 45), 4, 60, torch.bfloat16),
        ("CPG=1 f32", (2, 8, 2, 150), 8, 140, torch.float32),
        ("CPG=1 bf16", (2, 8, 2, 150), 8, 140, torch.bfloat16),
        ("CPG=32 f32", (1, 64, 3, 130), 2, 48, torch.float32),
        ("CPG=32 bf16", (1, 64, 3, 130), 2, 48, torch.bfloat16),
        ("CPG=32 W=128 f32", (1, 64, 3, 128), 2, 48, torch.float32),
        ("CPG=32 W=128 bf16", (1, 64, 3, 128), 2, 48, torch.bfloat16),
        ("CPG=2 f32", (2, 8, 3, 100), 4, 48, torch.float32),
        ("CPG=2 bf16", (2, 8, 3, 100), 4, 48, torch.bfloat16),
        ("CPG=16 f32", (1, 32, 3, 256), 2, 48, torch.float32),
        ("CPG=16 bf16", (1, 32, 3, 256), 2, 48, torch.bfloat16),
        ("middlebury f32", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, torch.float32),
        ("middlebury bf16", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, torch.bfloat16),
        ("kitti batch f32", (12,) + TRAIN_SHAPE[1:], MAIN_GROUPS, MAIN_D, torch.float32),
        ("kitti batch bf16", (12,) + TRAIN_SHAPE[1:], MAIN_GROUPS, MAIN_D, torch.bfloat16),
    ]
    bwd_errs = {}
    for name, shape, groups, d, dtype in bwd_cases:
        b, c, h, w = shape
        left, right = randn(shape, dtype), randn(shape, dtype)
        grad = randn((b, groups, d, h, w), dtype)
        got = gwc.gwc_volume_backward_cuda(grad, left, right, d, groups)
        want = gwc.gwc_volume_backward_reference(grad, left, right, d, groups)
        torch.cuda.synchronize()
        bwd_errs[name] = max(
            check_close(f"gwc backward {name} {tuple(shape)} G={groups} D={d} {part}", g_, w_, *bwd_tol(dtype, w_))
            for part, g_, w_ in (("dL", got[0], want[0]), ("dR", got[1], want[1]))
        )
        del left, right, grad, got, want
    torch.cuda.empty_cache()

    # conv3d forward. f32: 27*C products summed in another order, so the
    # tolerance scales with the output's magnitude: 1e-5 * max(1, max|ref|).
    # bf16: both sum in f32 and round once, so one bf16 ulp (2^-7 relative)
    # on top of that.
    def conv_tol(dtype, ref):
        scale = max(1.0, float(ref.float().abs().max()))
        return 1e-5 * scale, (0.0 if dtype == torch.float32 else 2.0**-7)

    conv_cases = [
        ("32->32 f32", CONV_SHAPE, 32, torch.float32, False),
        ("32->32 f32 scale+bias+relu", CONV_SHAPE, 32, torch.float32, True),
        ("32->32 bf16 scale+bias+relu", CONV_SHAPE, 32, torch.bfloat16, True),
        ("64->32 f32 scale+bias+relu", CONV_SHAPE_64, 32, torch.float32, True),
        ("64->32 bf16", CONV_SHAPE_64, 32, torch.bfloat16, False),
        ("ragged f32 scale+bias+relu", (2, 5, 3, 9, 33), 40, torch.float32, True),
        ("ragged bf16", (2, 5, 3, 9, 33), 40, torch.bfloat16, False),
        # the f32 (3xTF32) kernel's edges: ragged H and W (W % 4 != 0: scalar
        # stores), D = 1, two Co tiles, C not a multiple of its 8-channel step
        ("H=7 W=45 f32 scale+bias+relu", (1, 32, 2, 7, 45), 32, torch.float32, True),
        ("D=1 f32", (2, 32, 1, 9, 72), 32, torch.float32, False),
        ("64->64 f32 scale+bias+relu", (1, 64, 6, 20, 72), 64, torch.float32, True),
        ("C=12 f32", (1, 12, 4, 10, 40), 32, torch.float32, False),
        ("C=5 f32 scale+bias+relu", (1, 5, 2, 5, 9), 40, torch.float32, True),
        # the bf16 tensor-core kernel's edges: two Co tiles, C not a multiple
        # of its 16-channel step, W not a multiple of 8 (scalar stores) with a
        # ragged H, and D = 1
        ("64->64 bf16 scale+bias+relu", (1, 64, 6, 20, 72), 64, torch.bfloat16, True),
        ("C=24 bf16", (1, 24, 4, 10, 40), 32, torch.bfloat16, False),
        ("W=33 bf16 scale+bias+relu", (1, 32, 3, 10, 33), 32, torch.bfloat16, True),
        ("D=1 bf16", (2, 32, 1, 12, 64), 32, torch.bfloat16, False),
    ]
    conv_errs = {}
    for name, xs, co, dtype, affine in conv_cases:
        x = randn(xs, dtype)
        w = randn((co, xs[1], 3, 3, 3), dtype, 0.1)
        sc = (torch.rand(co, generator=gen, device="cuda") + 0.5) if affine else None
        bi = randn((co,), torch.float32, 0.1) if affine else None
        got = cv.conv3d_cuda(x, w, sc, bi, relu=affine)
        want = cv.conv3d_reference(x, w, sc, bi, relu=affine)
        torch.cuda.synchronize()
        conv_errs[name] = check_close(f"conv3d {name} x{tuple(xs)}", got, want, *conv_tol(dtype, want))
        del x, got, want

    # conv3d_fast backward (ReLU) against autograd through the plain conv,
    # both given the grad masked by the kernel's own y > 0 (the plain
    # output's sign differs where |y| is within rounding of 0, and a flipped
    # mask moves dx by a whole tap): dx is the kernel (tolerance as the
    # forward); dw is the library's wgrad, summed over every output point in
    # another order (1e-4 of max|dw| in f32, 1e-2 in bf16, which may round
    # partial sums).
    bwd_conv_errs = {}
    for name, xs, dtype in (("32->32 f32", CONV_SHAPE, torch.float32), ("32->32 bf16", CONV_SHAPE, torch.bfloat16),
                            ("64->32 f32", CONV_SHAPE_64, torch.float32), ("64->32 bf16", CONV_SHAPE_64, torch.bfloat16)):
        x = randn(xs, dtype).requires_grad_()
        w = randn((32, xs[1], 3, 3, 3), dtype, 0.1).requires_grad_()
        y = cv.conv3d_fast(x, w, True)
        g = randn(y.shape, dtype)
        dx, dw = torch.autograd.grad(y, (x, w), g)
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        gm = torch.where(y.detach() > 0, g, torch.zeros((), dtype=dtype, device="cuda"))
        dxr, dwr = torch.autograd.grad(cv.conv3d_reference(xr, wr), (xr, wr), gm)
        torch.cuda.synchronize()
        dw_scale = float(dwr.float().abs().max())
        bwd_conv_errs[name] = check_close(f"conv3d_fast backward {name} dx", dx, dxr, *conv_tol(dtype, dxr))
        check_close(f"conv3d_fast backward {name} dw (library wgrad)", dw, dwr,
                    (1e-4 if dtype == torch.float32 else 1e-2) * dw_scale, 0.0)
        del x, w, y, g, gm, dx, dw, xr, wr, dxr, dwr
    torch.cuda.empty_cache()

    flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB > 50 MB L2
    timing = {"gwc": {}, "gwc_bwd": {}, "conv3d": {}}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        left, right = randn(MAIN_SHAPE, dtype), randn(MAIN_SHAPE, dtype)
        ms = time_cuda(lambda: gwc.gwc_volume_cuda(left, right, MAIN_D, MAIN_GROUPS), 20, flush=flush)
        plain_ms = time_cuda(lambda: gwc.gwc_volume_reference(left, right, MAIN_D, MAIN_GROUPS), 5, flush=flush)
        bound_ms, bound_by = gwc_bound_ms(MAIN_SHAPE, MAIN_GROUPS, MAIN_D, left.element_size())
        timing["gwc"][tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        log(f"[kernels] gwc main {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")

        for shape_tag, xs in (("train", TRAIN_SHAPE), ("kitti eval", KITTI_EVAL_SHAPE)):
            left, right = randn(xs, dtype), randn(xs, dtype)
            ms = time_cuda(lambda: gwc.gwc_volume_cuda(left, right, MAIN_D, MAIN_GROUPS), 20, flush=flush)
            plain_ms = time_cuda(lambda: gwc.gwc_volume_reference(left, right, MAIN_D, MAIN_GROUPS), 5, flush=flush)
            bound_ms, bound_by = gwc_bound_ms(xs, MAIN_GROUPS, MAIN_D, left.element_size())
            timing["gwc"][f"{shape_tag} {tag}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                                       library_ms=None)
            log(f"[kernels] gwc {shape_tag} {tag} x{tuple(xs)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")
        for shape_tag, xs, d in (("train", TRAIN_SHAPE, MAIN_D), ("middlebury", MIDDLEBURY_SHAPE, MIDDLEBURY_D)):
            b, c, h, w = xs
            left, right = randn(xs, dtype), randn(xs, dtype)
            grad = randn((b, MAIN_GROUPS, d, h, w), dtype)
            ms = time_cuda(lambda: gwc.gwc_volume_backward_cuda(grad, left, right, d, MAIN_GROUPS), 20, flush=flush)
            plain_ms = time_cuda(_gwc_backward_plain(left, right, grad, d, MAIN_GROUPS), 5, flush=flush)
            bound_ms, bound_by = gwc_backward_bound_ms(xs, MAIN_GROUPS, d, left.element_size())
            key = tag if shape_tag == "train" else f"{shape_tag} {tag}"
            timing["gwc_bwd"][key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                          library_ms=None)
            log(f"[kernels] gwc backward {shape_tag} {tag} x{tuple(xs)} D={d}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")

        for shape_tag, xs in (("32->32", CONV_SHAPE), ("64->32", CONV_SHAPE_64)):
            x = randn(xs, dtype)
            w = randn((32, xs[1], 3, 3, 3), dtype, 0.1)
            ms = time_cuda(lambda: cv.conv3d_cuda(x, w), 10, flush=flush)
            plain_ms = time_cuda(lambda: cv.conv3d_reference(x, w), 3, flush=flush)
            library_ms = time_cuda(lambda: F.conv3d(x, w, padding=1), 10, flush=flush)
            bound_ms, bound_by = conv3d_bound_ms(xs, 32, x.element_size())
            entry = timing["conv3d"][f"{shape_tag} {tag}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
            extra = ""
            if dtype == torch.float32:
                entry["fma_bound_ms"] = conv3d_bound_ms(xs, 32, 4, fma=True)[0]
                extra = (f" (3xTF32 on the tensor cores; the FMA bound {entry['fma_bound_ms']:.4f} ms, "
                         f"{entry['fma_bound_ms'] / ms:.1%})")
            log(f"[kernels] conv3d {shape_tag} {tag} x{tuple(xs)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.conv3d {library_ms:.4f} ms, kernel / F.conv3d {ms / library_ms:.3f}, bound {bound_ms:.4f} ms "
                f"({bound_by}), {bound_ms / ms:.1%} of bound{extra} (cold L2)")
            if dtype == torch.float32:
                entry["library_tf32"] = library_tf32(x, w, flush)
            del x, w
    # the gwc forward at the main shape once more, after everything else: the
    # first f32 timing above has read up to ~15 % above later ones in the
    # same process (not the clock, fresh memory or the host: PERF.md §7)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        left, right = randn(MAIN_SHAPE, dtype), randn(MAIN_SHAPE, dtype)
        ms = time_cuda(lambda: gwc.gwc_volume_cuda(left, right, MAIN_D, MAIN_GROUPS), 20, flush=flush)
        timing["gwc"][tag]["ms_retimed"] = ms
        log(f"[kernels] gwc main {tag} retimed: kernel {ms:.4f} ms, {timing['gwc'][tag]['bound_ms'] / ms:.1%} of bound")
        # and the backward at the train shape, for the same reason
        b, c, h, w = TRAIN_SHAPE
        left, right = randn(TRAIN_SHAPE, dtype), randn(TRAIN_SHAPE, dtype)
        grad = randn((b, MAIN_GROUPS, MAIN_D, h, w), dtype)
        ms = time_cuda(lambda: gwc.gwc_volume_backward_cuda(grad, left, right, MAIN_D, MAIN_GROUPS), 20, flush=flush)
        timing["gwc_bwd"][tag]["ms_retimed"] = ms
        log(f"[kernels] gwc backward train {tag} retimed: kernel {ms:.4f} ms, "
            f"{timing['gwc_bwd'][tag]['bound_ms'] / ms:.1%} of bound")
    del flush
    torch.cuda.empty_cache()
    return dict(gwc=errs, gwc_bwd=bwd_errs, conv3d=conv_errs, conv3d_bwd=bwd_conv_errs), timing


def seeded_flax_variables(model, seed: int):
    """Flat flax variables for `model`, drawn with numpy: reference-init conv
    kernels (normal, std sqrt(2/fan_out)), BN affine and running statistics as
    the parity tests randomise them."""
    from dcanet_tpu_torch import weights

    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in weights.to_jax_variables(model.state_dict(), model.num_cva).items():
        shape = ref.shape
        if key.endswith("/mean"):
            arr = rng.normal(0.0, 0.2, shape)
        elif key.endswith("/var") or key.endswith("/scale"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("/bias"):
            arr = rng.normal(0.0, 0.1, shape)
        else:
            fan_out = math.prod(shape[:-2]) * shape[-1]
            arr = rng.normal(0.0, math.sqrt(2.0 / fan_out), shape)
        flat[key] = arr.astype(np.float32)
    return flat


def synthetic_pair(seed: int):
    """A KITTI-sized textured stereo pair (uint8 RGB): the right image is the
    left one shifted by a disparity d that grows down the image,
    left[y, x] = right[y, x - d]."""
    rng = np.random.default_rng(seed)
    h, w = KITTI_HW
    pad = 96
    base = rng.integers(0, 256, size=(h // 4 + 1, (w + pad) // 4 + 1, 3)).astype(np.float32)
    tex = np.repeat(np.repeat(base, 4, axis=0), 4, axis=1)[:h, : w + pad]
    left = tex[:, :w]
    right = np.empty_like(left)
    for y in range(h):
        d = 8 + (80 * y) // h
        right[y] = tex[y, d : d + w]
    return left.astype(np.uint8), right.astype(np.uint8)


def profile_call(fn, tag: str, top: int = 6) -> None:
    """One profiled call of `fn`: the sum of kernel time against the call's
    wall time (the device's busy share), and the kernels that take most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"[profile {tag}] the profiler recorded no device time")
        return
    log(f"[profile {tag}] kernels {busy_ms:.3f} ms of a {wall_ms:.3f} ms profiled call "
        f"(device busy {busy_ms / wall_ms:.1%}), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile {tag}]   {ms:8.3f} ms {ms / busy_ms:6.1%} x{e.count:<4d} {e.key[:110]}")


def phase_model(flat):
    """DCANet(num_cva=3) eval at 384x1248 in bf16 and f32; GPU vs CPU model."""
    import torch

    from dcanet_tpu_torch import weights
    from dcanet_tpu_torch.data.submission import to_submission_shape, whiten_per_channel
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models import DCANet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = DCANet(maxdisp=192, num_cva=3)
    model.load_state_dict(weights.from_jax_variables(flat, 3), strict=True)
    model.eval()

    left, right = synthetic_pair(SEED)
    tl, tr = (
        torch.from_numpy(to_submission_shape(whiten_per_channel(x))[0].transpose(2, 0, 1)[None].copy())
        for x in (left, right)
    )
    gpu = model.cuda()
    tl, tr = tl.cuda(), tr.cuda()
    disp, results = {}, {}
    for tag, bf16 in (("bf16", True), ("f32", False)):
        def fwd():
            with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=bf16):
                return gpu(tl, tr)

        gwc.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if gwc.LAUNCHES != 1:
            raise AssertionError(f"[model {tag}] gwc kernel launched {gwc.LAUNCHES} times in one forward")
        d = out.disparity
        if d.shape != (1, 384, 1248) or d.dtype != torch.float32 or not bool(torch.isfinite(d).all()):
            raise AssertionError(f"[model {tag}] disparity {tuple(d.shape)} {d.dtype}, finite={bool(torch.isfinite(d).all())}")
        for lg in out.class_logits:
            if lg.shape != (1, 24, 48, 156) or not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"[model {tag}] class logits {tuple(lg.shape)} not finite or misshapen")
        disp[tag] = d.cpu().numpy()[0]
        iters = 10
        ms = time_cuda(fwd, iters)
        if gwc.LAUNCHES != 1 + 2 + iters:
            raise AssertionError(f"[model {tag}] {gwc.LAUNCHES} gwc launches for {3 + iters} forwards")
        results[tag] = dict(ms=ms, pairs_per_s=1e3 / ms, peak_bytes=peak)
        log(f"[model] DCANet(num_cva=3, maxdisp=192) eval {tag} 1x3x384x1248: {ms:.3f} ms/pair, "
            f"{1e3 / ms:.3f} pairs/s, peak memory {peak / 2**30:.3f} GiB above weights, "
            f"disparity range [{disp[tag].min():.3f}, {disp[tag].max():.3f}], 1 gwc launch per forward")
        profile_call(fwd, tag)
    diff = np.abs(disp["bf16"] - disp["f32"])
    log(f"[model] bf16 vs f32 disparity: mean |diff| {diff.mean():.4f} px, max {diff.max():.4f} px")

    # the GPU model (gwc kernel, cuDNN) against the CPU model (plain gwc) on a
    # small pair; tolerance as the JAX package's eval parity (5e-3 px)
    rng = np.random.default_rng(SEED + 1)
    sl, sr = (torch.from_numpy(rng.standard_normal((1, 3, 64, 256)).astype(np.float32)) for _ in range(2))
    with torch.inference_mode():
        want = model.cpu()(sl, sr).disparity
        gpu = model.cuda()
        got = gpu(sl.cuda(), sr.cuda()).disparity.cpu()
    small_err = float((got - want).abs().max())
    log(f"[model] GPU vs CPU model, 1x3x64x256 f32: max |diff| {small_err:.3e} px (atol 5e-3)")
    if not small_err <= 5e-3:
        raise AssertionError("GPU model disagrees with the CPU model on the small pair")
    results["small_err"] = small_err
    return results, disp["f32"]


def phase_serving(flat, ref_disp, workdir: Path):
    """Three `cli infer --submission` requests; returns the gwc launch count."""
    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.data.io import read_png, write_png
    from dcanet_tpu_torch.data.submission import from_submission_shape
    from dcanet_tpu_torch.kernels import gwc

    left, right = synthetic_pair(SEED)
    lp, rp, wp = workdir / "left.png", workdir / "right.png", workdir / "weights.npz"
    write_png(lp, left)
    write_png(rp, right)
    np.savez(wp, **flat)
    ref = from_submission_shape(ref_disp, KITTI_HW)

    gwc.LAUNCHES = 0
    outs = []
    for i in range(3):
        out = workdir / f"disp_{i}.png"
        t0 = time.perf_counter()
        cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out),
                  "--submission", "--weights", str(wp), "--device", "cuda"])
        log(f"[serving] request {i}: {time.perf_counter() - t0:.3f} s wall, incl. model build and weight load")
        outs.append(out)
    launches = gwc.LAUNCHES
    if launches != 3:
        raise AssertionError(f"[serving] gwc kernel launched {launches} times for 3 requests")
    for out in outs:
        png = read_png(out)
        if png.shape != KITTI_HW or png.dtype != np.uint16:
            raise AssertionError(f"[serving] {out.name}: {png.shape} {png.dtype}, expected {KITTI_HW} uint16")
        served = png.astype(np.float32) / 256.0
        close = np.abs(served - np.clip(ref, 0, 65535 / 256.0)) <= 1.0 / 128
        log(f"[serving] {out.name}: {png.shape} uint16, {close.mean():.4%} of pixels within 1/128 px "
            "of the phase-3 f32 disparity")
        if close.mean() < 0.99:
            raise AssertionError(f"[serving] {out.name} disagrees with the model run of phase 3")
    return launches


def phase_conv3d_path():
    """The conv3d kernel's own path, the counterpart of the JAX package's
    tools/bench_conv3d.py::run_pallas, in f32 and again in bf16 (its `--bf16`
    flag): the plain conv and the scale+bias+ReLU conv at 32 -> 32, the
    64 -> 32 conv, and one conv3d_fast forward and backward (the JAX
    package's custom_vjp, whose dgrad is the kernel). Returns the launch
    counts of the f32 (3xTF32) and the bf16 kernel on this path."""
    import torch

    from dcanet_tpu_torch.kernels import conv3d as cv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(CONV_SHAPE, generator=gen, device="cuda")
    w = torch.randn((32, 32, 3, 3, 3), generator=gen, device="cuda") * 0.1
    x64 = torch.randn(CONV_SHAPE_64, generator=gen, device="cuda")
    w64 = torch.randn((32, 64, 3, 3, 3), generator=gen, device="cuda") * 0.1
    sc = torch.ones(32, device="cuda")
    bi = torch.zeros(32, device="cuda")
    launches = {}
    for tag, dtype, rtol in (("f32", torch.float32, 0.0), ("bf16", torch.bfloat16, 2.0**-7)):
        xd, wd, x64d, w64d = (t.to(dtype) for t in (x, w, x64, w64))
        cv.LAUNCHES = cv.BF16_LAUNCHES = 0
        outs = [cv.conv3d(xd, wd), cv.conv3d(xd, wd, sc, bi, relu=True), cv.conv3d(x64d, w64d)]
        xg, wg = xd.clone().requires_grad_(), wd.clone().requires_grad_()
        y = cv.conv3d_fast(xg, wg, True)
        y.backward(torch.ones_like(y))
        torch.cuda.synchronize()
        n, n_bf16 = cv.LAUNCHES, cv.BF16_LAUNCHES
        launches[tag] = n_bf16 if dtype == torch.bfloat16 else n - n_bf16
        if n != 5 or launches[tag] != 5:
            raise AssertionError(f"[conv3d path {tag}] {n} kernel launches ({n_bf16} bf16), expected 3 convs + "
                                 f"1 forward + 1 dgrad of the {tag} kernel")
        want = cv.conv3d_reference(xd, wd).float()
        atol = 1e-5 * max(1.0, float(want.abs().max()))
        errs = [(outs[0].float() - want).abs(), (outs[1].float() - torch.relu(want)).abs()]
        bad = sum(int((e > atol + rtol * r.abs()).sum()) for e, r in zip(errs, (want, torch.relu(want))))
        finite = all(bool(torch.isfinite(t).all()) for t in (*outs, y, xg.grad, wg.grad))
        log(f"[conv3d path {tag}] 3 convs + conv3d_fast fwd/bwd at {CONV_SHAPE} and {CONV_SHAPE_64}: {n} launches, "
            f"max|err| vs plain {float(errs[0].max()):.3e} (affine+relu {float(errs[1].max()):.3e}; atol {atol:.3g}, "
            f"rtol {rtol:g}), all finite: {finite}")
        if not finite or bad:
            raise AssertionError(f"[conv3d path {tag}] outputs not finite or off the plain version")
        del xd, wd, x64d, w64d, outs, xg, wg, y, want, errs
    return launches


def phase_train(workdir: Path):
    """`cli train --preset sceneflow` at full width on a synthetic SceneFlow
    tree at 540x960, the preset's random 256x512 crop, batch 1, f32, then a
    resumed epoch. Returns the numbers for the summary."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree
    from dcanet_tpu_torch.kernels import gwc

    t0 = time.perf_counter()
    root = write_sceneflow_tree(workdir / "sceneflow", TRAIN_PAIRS, SCENEFLOW_HW, seed=SEED)
    log(f"[train] wrote {TRAIN_PAIRS} synthetic SceneFlow pairs at {SCENEFLOW_HW} in {time.perf_counter() - t0:.2f} s")
    logdir = workdir / "run"
    args = ["train", "--preset", "sceneflow", "--data-root", str(root), "--logdir", str(logdir),
            "--batch-size", "1", "--dtype", "float32", "--seed", str(SEED), "--print-freq", "1",
            "--num-workers", "4", "--device", "cuda"]

    gwc.LAUNCHES = gwc.BACKWARD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    hist = cli.main(args + ["--epochs", str(TRAIN_EPOCHS)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = gwc.LAUNCHES, gwc.BACKWARD_LAUNCHES
    steps = len(hist)
    if steps != TRAIN_PAIRS * TRAIN_EPOCHS:
        raise AssertionError(f"[train] {steps} steps, expected {TRAIN_PAIRS * TRAIN_EPOCHS}")
    for rec in hist:
        log(f"[train] step {rec['step']}: loss {rec['total']:.4f} (focal {rec['focal']:.4f}, smooth-L1 "
            f"{rec['smooth_l1']:.4f}), grad norm {rec['grad_norm']:.4f}, epe {rec['epe']:.4f}")
        if not all(math.isfinite(rec[k]) for k in ("total", "focal", "smooth_l1", "grad_norm", "epe")):
            raise AssertionError(f"[train] step {rec['step']} is not finite: {rec}")
    if fwd != steps or bwd != steps:
        raise AssertionError(f"[train] gwc forward {fwd} / backward {bwd} launches in {steps} steps")
    step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(hist, hist[1:])][TRAIN_WARMUP - 1:]
    ms = statistics.median(step_ms)
    log(f"[train] DCANet(num_cva=3, maxdisp=192) f32, 1x3x256x512 crops: {steps} steps, "
        f"{fwd} gwc forward and {bwd} gwc backward launches (1 each per step); median {ms:.3f} ms/step "
        f"over steps {TRAIN_WARMUP}-{steps - 1} (range {min(step_ms):.3f}-{max(step_ms):.3f}), "
        f"{1e3 / ms:.3f} pairs/s, peak memory {peak / 2**30:.3f} GiB")

    ckpts = sorted(p.name for p in (logdir / "ckpt").iterdir())
    want = [f"ckpt_{TRAIN_PAIRS * (e + 1):08d}.pt" for e in range(TRAIN_EPOCHS)]
    if ckpts != want:
        raise AssertionError(f"[train] checkpoints {ckpts}, expected {want}")
    gwc.LAUNCHES = gwc.BACKWARD_LAUNCHES = 0
    resumed = cli.main(args + ["--epochs", str(TRAIN_EPOCHS + 1), "--resume"])
    if [r["step"] for r in resumed] != list(range(steps, steps + TRAIN_PAIRS)):
        raise AssertionError(f"[train] the resumed run took steps {[r['step'] for r in resumed]}")
    if not all(math.isfinite(r["total"]) for r in resumed):
        raise AssertionError("[train] the resumed run's loss is not finite")
    log(f"[train] checkpoints {ckpts}; resumed at step {resumed[0]['step']}, {len(resumed)} more steps, "
        f"loss {resumed[0]['total']:.4f} -> {resumed[-1]['total']:.4f}")
    resumed_fwd, resumed_bwd = gwc.LAUNCHES, gwc.BACKWARD_LAUNCHES
    infer_launches = serve_from_logdir(logdir, workdir)
    alone = profile_train_step(root)
    return dict(alone=alone, steps=steps, ms=ms, pairs_per_s=1e3 / ms, peak_bytes=peak, fwd=fwd, bwd=bwd,
                resumed_fwd=resumed_fwd, resumed_bwd=resumed_bwd, infer=infer_launches)


def serve_from_logdir(logdir: Path, workdir: Path) -> int:
    """One `cli infer --submission --logdir` request from the train run's
    newest checkpoint, f32; the served PNG against the checkpoint's "model"
    weights run in-process on the same pair. Returns the request's gwc
    launches."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.data.io import read_png, write_png
    from dcanet_tpu_torch.data.submission import from_submission_shape, to_submission_shape, whiten_per_channel
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models import DCANet

    left, right = synthetic_pair(SEED)
    lp, rp, out = workdir / "train_left.png", workdir / "train_right.png", workdir / "train_disp.png"
    write_png(lp, left)
    write_png(rp, right)
    gwc.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out), "--submission",
              "--logdir", str(logdir), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = gwc.LAUNCHES
    if launches != 1:
        raise AssertionError(f"[train infer] gwc kernel launched {launches} times for 1 request")

    newest = sorted((logdir / "ckpt").iterdir())[-1]
    model = DCANet(maxdisp=192, num_cva=3)
    model.load_state_dict(torch.load(newest, map_location="cpu", weights_only=True)["model"], strict=True)
    model = model.cuda().eval()
    tl, tr = (torch.from_numpy(to_submission_shape(whiten_per_channel(x.astype(np.float32)))[0]
                               .transpose(2, 0, 1)[None].copy()).cuda() for x in (left, right))
    with torch.inference_mode():
        ref = from_submission_shape(model(tl, tr).disparity[0].float().cpu().numpy(), KITTI_HW)
    png = read_png(out)
    if png.shape != KITTI_HW or png.dtype != np.uint16:
        raise AssertionError(f"[train infer] {out.name}: {png.shape} {png.dtype}, expected {KITTI_HW} uint16")
    close = np.abs(png.astype(np.float32) / 256.0 - np.clip(ref, 0, 65535 / 256.0)) <= 1.0 / 128
    log(f"[train infer] cli infer --submission --logdir: {newest.name}, {wall:.3f} s wall, {launches} gwc launch, "
        f"{close.mean():.4%} of pixels within 1/128 px of the checkpoint's weights run in-process")
    if close.mean() < 0.99:
        raise AssertionError("[train infer] the served PNG disagrees with the checkpoint's weights")
    return launches


def profile_train_step(root: Path) -> dict:
    """The train step alone, on one batch already on the card (no loader),
    in f32, in bf16 autocast (`--dtype bfloat16`) and in f32 with `--remat`:
    median ms of 5 steps after 2 warm-ups, peak memory, finite losses; then
    one profiled f32 step (device busy share and the kernels that take
    most). Its launches are not counted as the path's."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.train.loop import LossConfig, train_step

    base = preset("sceneflow", data_root=str(root), seed=SEED)
    sample = cli.build_dataset(base, training=True)[0]
    batch = {k: torch.from_numpy(v[None]).cuda() for k, v in sample.items()}
    loss_cfg = LossConfig(max_disp=base.maxdisp)
    results = {}
    for tag, overrides in (("f32", {}), ("bf16 autocast", {"dtype": "bfloat16"}), ("f32 remat", {"remat": True})):
        state = cli.build_train_state(preset("sceneflow", seed=SEED, **overrides), TRAIN_PAIRS, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(train_step(state, batch, loss_cfg)["total"]))
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(times)
        results[tag] = dict(ms=ms, peak_bytes=peak)
        log(f"[train] the train step alone, {tag} (batch on the card, no loader): median {ms:.3f} ms over 5 steps "
            f"(range {min(times):.3f}-{max(times):.3f}), peak memory {peak / 2**30:.3f} GiB, "
            f"losses {', '.join(f'{x:.3f}' for x in losses)}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[train] {tag}: a loss is not finite")
        if tag == "f32":
            profile_call(lambda: train_step(state, batch, loss_cfg), "train step", top=10)
        del state
        torch.cuda.empty_cache()
    return results


def phase_train_parity():
    """One GPU train step (CUDA kernels, cuDNN) against one CPU train step
    (plain versions) from the same weights on a small input: loss, grad
    norm and the updated BatchNorm statistics."""
    import copy

    import torch

    from dcanet_tpu_torch.models import DCANet
    from dcanet_tpu_torch.nn.layers import reference_init_
    from dcanet_tpu_torch.train.loop import LossConfig, train_step
    from dcanet_tpu_torch.train.state import create_train_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = reference_init_(DCANet(maxdisp=192, num_cva=3), torch.Generator().manual_seed(SEED + 3))
    rng = np.random.default_rng(SEED + 3)
    batch = {
        "left": rng.standard_normal((1, 3, 64, 128)).astype(np.float32),
        "right": rng.standard_normal((1, 3, 64, 128)).astype(np.float32),
        "disparity": rng.uniform(1.0, 60.0, (1, 64, 128)).astype(np.float32),
    }
    cfg = LossConfig(max_disp=192)
    results = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        state = create_train_state(m, lambda step: 1e-3)
        metrics = train_step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg)
        stats = {k: v.detach().cpu() for k, v in m.state_dict().items() if "running" in k}
        results[dev] = ({k: float(v) for k, v in metrics.items()}, stats)
    (mc, sc), (mg, sg) = results["cpu"], results["cuda"]
    stat_err = max(float((sc[k] - sg[k]).abs().max()) for k in sc)
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in ("total", "focal", "smooth_l1", "grad_norm")}
    log(f"[train parity] GPU vs CPU train step, 1x3x64x128 f32: loss {mg['total']:.6f} vs {mc['total']:.6f}, "
        f"grad norm {mg['grad_norm']:.6f} vs {mc['grad_norm']:.6f}; relative differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"; BatchNorm statistics max|diff| {stat_err:.3e} (tolerances: loss terms 1e-4, grad norm 1e-3, "
        "statistics 1e-4)")
    if max(rel["total"], rel["focal"], rel["smooth_l1"]) > 1e-4 or rel["grad_norm"] > 1e-3 or stat_err > 1e-4:
        raise AssertionError("[train parity] the GPU train step disagrees with the CPU train step")
    return dict(rel=rel, stat_err=stat_err)


def _eval_reference(model, ds, bf16: bool, maxdisp: int = 192):
    """The eval command's numbers from direct model calls on the same
    transformed pairs: EPE, D1 and >1/2/3 px with numpy (float32 errors,
    float64 means), the per-image skip rule, the means weighted by the
    images kept; and per CVA volume the (gt class, argmax class) counts."""
    import torch

    from dcanet_tpu_torch.data.eval_protocol import eval_transform

    sums, kept, confusions = dict.fromkeys(("epe", "d1", "thres1", "thres2", "thres3"), 0.0), 0, None
    for i in range(len(ds)):
        left, right, gt, pads = eval_transform(ds[i], "kitti")
        tl, tr = (torch.from_numpy(np.ascontiguousarray(x[None])).cuda() for x in (left, right))
        with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=bf16):
            out = model(tl, tr)
        disp = out.disparity[0].float().cpu().numpy()
        disp = disp[pads[0]:, : disp.shape[1] - pads[1]]
        mask = (gt > 0) & (gt < maxdisp)
        if mask.mean() >= 0.1 * (gt > 0).mean() and (gt > 0).any():
            err = np.abs(disp - gt)[mask]
            bad = {"epe": err, "d1": (err > 3.0) & (err > 0.05 * np.abs(gt[mask])),
                   "thres1": err > 1.0, "thres2": err > 2.0, "thres3": err > 3.0}
            for k, v in bad.items():
                sums[k] += float(v.astype(np.float64).mean())
            kept += 1
        gt_model = np.pad(gt, [(pads[0], 0), (0, pads[1])])
        counts = []
        for lg in out.class_logits:
            n, hp, wp = lg.shape[1:]
            scale = gt_model.shape[1] // wp
            gt_cls = np.floor(gt_model.astype(np.float64).reshape(hp, scale, wp, scale).mean(axis=(1, 3)) / 8.0)
            pred = lg[0].float().argmax(dim=0).cpu().numpy()
            ok = (gt_cls >= 0) & (gt_cls < n)
            counts.append(np.bincount((gt_cls[ok] * n + pred[ok]).astype(np.int64), minlength=n * n).reshape(n, n))
        confusions = counts if confusions is None else [a + c for a, c in zip(confusions, counts)]
    return {k: v / max(kept, 1) for k, v in sums.items()}, kept, confusions


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the duration. Its default f32
    ConvTranspose3d algorithm adds with atomics, so two f32 forwards of one
    pair may differ in the last bits; a check that holds one run against
    another needs the same fixed order in both."""
    import torch

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _eval_parts(model, ds, bf16: bool) -> dict:
    """Where an eval pair's time goes: the host's decode and transform of a
    pair (median over the pairs), and the forward alone on the first pair
    (CUDA events, median of 5)."""
    import torch

    from dcanet_tpu_torch.data.eval_protocol import eval_transform

    host = []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        left, right, _, _ = eval_transform(ds[i], "kitti")
        host.append(1e3 * (time.perf_counter() - t0))
    tl, tr = (torch.from_numpy(np.ascontiguousarray(x[None])).cuda() for x in eval_transform(ds[0], "kitti")[:2])

    def fwd():
        with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=bf16):
            return model(tl, tr)

    return dict(host_ms=statistics.median(host), forward_ms=time_cuda(fwd, 5))


def phase_eval(workdir: Path, train_logdir) -> dict:
    """`cli eval --preset kitti --dataset kitti2015` with DCANet(num_cva=3,
    maxdisp=192) on a synthetic KITTI 2015 tree at 375x1242, in f32 and in
    bf16, with the weights of phase 6's newest checkpoint (`train_logdir`)
    or, without it, the seed-0 reference init: one gwc launch per pair, the
    metrics and the class scores against `_eval_reference`, readable image
    panels; then `cli infer --list` over 3 names against single `infer
    --submission` requests, and with a train run, `cli export` then `infer
    --weights` against `infer --logdir`, bit for bit; each check that holds
    one run against another under `cudnn_deterministic`, the timed run with
    cuDNN's defaults."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.data.eval_protocol import KITTI_H, KITTI_W
    from dcanet_tpu_torch.data.io import read_png
    from dcanet_tpu_torch.data.synthetic import write_kitti2015_tree
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models import DCANet
    from dcanet_tpu_torch.nn.layers import reference_init_
    from dcanet_tpu_torch.train.checkpoint import checkpoint_step, latest_checkpoint
    from dcanet_tpu_torch.train.metrics import segmentation_scores

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    root = write_kitti2015_tree(workdir / "kitti", EVAL_PAIRS, KITTI_HW, seed=SEED, out_of_range_pair=EVAL_PAIRS - 1)
    log(f"[eval] wrote {EVAL_PAIRS} synthetic KITTI 2015 pairs at {KITTI_HW} (sparse gt; the last one's mostly "
        f"at maxdisp) in {time.perf_counter() - t0:.2f} s")
    model = DCANet(maxdisp=192, num_cva=3)
    if train_logdir is not None:
        newest = latest_checkpoint(train_logdir / "ckpt")
        step = checkpoint_step(newest)
        ckpt_args, infer_args = ["--ckpt", str(train_logdir / "ckpt")], ["--logdir", str(train_logdir)]
        model.load_state_dict(torch.load(newest, map_location="cpu", weights_only=True)["model"], strict=True)
    else:
        step, ckpt_args, infer_args = 0, [], []
        reference_init_(model, torch.Generator().manual_seed(0))  # eval's and infer's default seed
    model = model.cuda().eval()
    ds = cli.build_dataset(preset("kitti", dataset="kitti2015", data_root=str(root)), training=False)

    def run_eval(tag, dtype, logdir, images):
        """One eval command; returns its results and its peak memory above
        the memory held before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gwc.LAUNCHES = 0
        got = cli.main(["eval", "--preset", "kitti", "--dataset", "kitti2015", "--data-root", str(root), "--logdir",
                        str(logdir), "--dtype", dtype, "--log-images", str(images), "--device", "cuda", *ckpt_args])
        n = gwc.LAUNCHES
        launches[tag] = launches.get(tag, 0) + n
        if n != EVAL_PAIRS:
            raise AssertionError(f"[eval {tag}] gwc kernel launched {n} times for {EVAL_PAIRS} pairs")
        return got, torch.cuda.max_memory_allocated() - base

    out, launches = {}, {}
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        logdir = workdir / f"eval_{tag}"
        with cudnn_deterministic():
            got, _ = run_eval(tag, dtype, logdir, 2)
            want, kept, confusions = _eval_reference(model, ds, dtype == "bfloat16")
        if kept != EVAL_PAIRS - 1:
            raise AssertionError(f"[eval {tag}] the skip rule kept {kept} of {EVAL_PAIRS} pairs")
        rel = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}
        log(f"[eval {tag}] metrics " + ", ".join(f"{k} {got[k]:.6f} (direct {want[k]:.6f}, rel {rel[k]:.1e})"
                                                 for k in want) + " (tolerance rel 1e-5)")
        if max(rel.values()) > 1e-5:
            raise AssertionError(f"[eval {tag}] metrics disagree with the direct model calls: {rel}")
        for vi, conf in enumerate(confusions):
            scores = segmentation_scores(torch.from_numpy(conf).float().cuda())
            wrong = {k: (got[f"vol{vi + 1}/{k}"], float(v)) for k, v in scores.items()
                     if got[f"vol{vi + 1}/{k}"] != float(v)}
            log(f"[eval {tag}] vol{vi + 1}: " + ", ".join(f"{k} {got[f'vol{vi + 1}/{k}']:.6f}" for k in scores)
                + f" over {int(conf.sum())} counted pixels; {'equal to' if not wrong else 'NOT equal to'} the "
                  "scores of a numpy count of the same logits")
            if wrong:
                raise AssertionError(f"[eval {tag}] vol{vi + 1} scores differ from the numpy count: {wrong}")
        panels = sorted((logdir / "images").iterdir())
        want_panels = [f"eval_sample{i}{s}_{step:08d}.png" for i in range(2)
                       for s in ("", "_probmass_vol1", "_probmass_vol2", "_probmass_vol3")]
        if [p.name for p in panels] != sorted(want_panels):
            raise AssertionError(f"[eval {tag}] panels {[p.name for p in panels]}, expected {sorted(want_panels)}")
        ch, cw = min(KITTI_H, KITTI_HW[0]), min(KITTI_W, KITTI_HW[1])  # the protocol's crop
        for name, shape in {p.name: read_png(p).shape for p in panels}.items():
            want_shape = (4 * ch, cw, 3) if "probmass" not in name else (ch // 8, cw // 8, 3)
            if shape != want_shape:
                raise AssertionError(f"[eval {tag}] panel {name}: {shape}, expected {want_shape}")
        # the time of the command as a user runs it: cuDNN's default
        # algorithms, no panels (with them, pair 2's panel PNGs fall inside
        # the timed pairs); its metrics may move by a pixel's count in f32
        timed, peak = run_eval(tag, dtype, workdir / f"eval_{tag}_timed", 0)
        parts = _eval_parts(model, ds, dtype == "bfloat16")
        moved = {k: abs(timed[k] - got[k]) / max(abs(got[k]), 1e-12) for k in want}
        if max(moved.values()) > 1e-3:
            raise AssertionError(f"[eval {tag}] the run with cuDNN's defaults moved the metrics: {moved}")
        out[tag] = dict(ms_per_pair=timed["ms_per_pair"], pairs_per_s=timed["pairs_per_s"], peak_bytes=peak,
                        ms_per_pair_with_panels=got["ms_per_pair"], metrics={k: got[k] for k in want},
                        miou=got["miou"], mpa=got["mpa"], **parts)
        log(f"[eval {tag}] cli eval, DCANet(num_cva=3, maxdisp=192), {EVAL_PAIRS} pairs at {ch}x{cw}: "
            f"{timed['ms_per_pair']:.3f} ms/pair, {timed['pairs_per_s']:.3f} pairs/s (host clock, pairs "
            f"2-{EVAL_PAIRS}: decode, transform, forward, metrics; {got['ms_per_pair']:.3f} ms/pair with "
            f"--log-images 2 and cuDNN's deterministic algorithms), peak memory {peak / 2**30:.3f} GiB above the "
            f"memory held before; metrics within rel {max(moved.values()):.1e} of the deterministic run's; "
            f"{launches[tag]} gwc launches in the two; {len(panels)} readable PNG panels; {gpu_line()}")
        log(f"[eval {tag}] parts: decode + transform of a pair {parts['host_ms']:.3f} ms (host, median), the "
            f"forward alone {parts['forward_ms']:.3f} ms (CUDA events, median of 5)")

    # the list and the single requests it is held against, bit for bit
    with cudnn_deterministic():
        lst = workdir / "test.txt"
        lst.write_text("\n".join(EVAL_LIST) + "\n")
        gwc.LAUNCHES = 0
        t0 = time.perf_counter()
        cli.main(["infer", "--list", str(lst), "--data-root", str(root), "--save-path", str(workdir / "submission"),
                  "--device", "cuda", *infer_args])
        launches["infer_list"] = gwc.LAUNCHES
        wall = time.perf_counter() - t0
        if launches["infer_list"] != len(EVAL_LIST):
            raise AssertionError(f"[eval] infer --list launched gwc {launches['infer_list']} times for "
                                 f"{len(EVAL_LIST)} names")

        def single(name, *weights):
            png = workdir / "single.png"
            cli.main(["infer", "--left", str(root / "image_2" / name), "--right", str(root / "image_3" / name),
                      "--out", str(png), "--submission", "--device", "cuda", *weights])
            return read_png(png)

        for name in EVAL_LIST:
            listed = read_png(workdir / "submission" / name)
            same = np.array_equal(listed, single(name, *infer_args))
            if listed.shape != KITTI_HW or listed.dtype != np.uint16 or not same:
                raise AssertionError(f"[eval] infer --list's {name} differs from a single --submission request")
        log(f"[eval] infer --list over {len(EVAL_LIST)} names: {wall:.3f} s wall, {launches['infer_list']} gwc "
            "launches (cuDNN's deterministic algorithms); each PNG equal to a single infer --submission request, "
            "bit for bit")
        if train_logdir is not None:
            export = workdir / "export.pt"
            cli.main(["export", "--logdir", str(train_logdir), "--out", str(export)])
            if not np.array_equal(single(EVAL_LIST[0], "--weights", str(export)), single(EVAL_LIST[0], *infer_args)):
                raise AssertionError("[eval] infer --weights <export> differs from infer --logdir")
            log(f"[eval] export of {train_logdir.name}'s step {step}: infer --weights on it equals infer --logdir, "
                "bit for bit")
    return dict(launches=launches, step=step, exported=train_logdir is not None, **out)


def kernel_entry(name, source, replaces, launches, by_path, err, t, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "launches_by_path": by_path, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"], **extra}


PHASES = ("kernels", "model", "serving", "conv3d_path", "train", "eval")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s to run after the build; the summary lines "
                         "are printed only when all run")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dcanet_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible device(s)")
    phase_build()
    errs, timing = phase_kernels() if "kernels" in phases else ({}, {})

    from dcanet_tpu_torch.models import DCANet

    flat = seeded_flax_variables(DCANet(maxdisp=192, num_cva=3), SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if "model" in phases or "serving" in phases:
            _, ref_disp = phase_model(flat)
        serving = phase_serving(flat, ref_disp, Path(tmp)) if "serving" in phases else None
        conv_launches = phase_conv3d_path() if "conv3d_path" in phases else None
        if "train" in phases:
            train = phase_train(Path(tmp))
            parity = phase_train_parity()
        if "eval" in phases:
            evaluation = phase_eval(Path(tmp), Path(tmp) / "run" if "train" in phases else None)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if phases != set(PHASES):
        log(f"[done] phases {sorted(phases)}; no summary for a subset")
        return 0

    gwc_t, bwd_t = timing["gwc"], timing["gwc_bwd"]
    eval_launches = evaluation["launches"]["f32"] + evaluation["launches"]["bf16"]
    conv_t = timing["conv3d"]
    kernels = [
        kernel_entry(
            "gwc_volume", "dcanet_tpu_torch/csrc/gwc.cu", "dcanet_tpu/kernels/gwc.py:51", eval_launches,
            {"eval": eval_launches, "infer_list": evaluation["launches"]["infer_list"], "train": train["fwd"],
             "serving": serving, "train_infer": train["infer"]}, errs["gwc"]["main f32"],
            gwc_t["f32"],
            dtype="float32", shape={"features": list(MAIN_SHAPE), "groups": MAIN_GROUPS, "maxdisp": MAIN_D},
            bfloat16={"max_abs_err": errs["gwc"]["main bf16"], **gwc_t["bf16"]},
            train_shape={"features": list(TRAIN_SHAPE), "float32": gwc_t["train f32"],
                         "bfloat16": gwc_t["train bf16"]},
            kitti_eval_shape={"features": list(KITTI_EVAL_SHAPE),
                              "float32": {"max_abs_err": errs["gwc"]["kitti eval f32"], **gwc_t["kitti eval f32"]},
                              "bfloat16": {"max_abs_err": errs["gwc"]["kitti eval bf16"],
                                           **gwc_t["kitti eval bf16"]}},
        ),
        kernel_entry(
            "gwc_volume_backward", "dcanet_tpu_torch/csrc/gwc.cu", "dcanet_tpu/kernels/gwc.py:133",
            train["bwd"], {"train": train["bwd"]}, errs["gwc_bwd"]["train f32"], bwd_t["f32"],
            dtype="float32", shape={"features": list(TRAIN_SHAPE), "groups": MAIN_GROUPS, "maxdisp": MAIN_D},
            bfloat16={"max_abs_err": errs["gwc_bwd"]["train bf16"], **bwd_t["bf16"]},
            middlebury_shape={"features": list(MIDDLEBURY_SHAPE), "maxdisp": MIDDLEBURY_D,
                              "float32": {"max_abs_err": errs["gwc_bwd"]["middlebury f32"], **bwd_t["middlebury f32"]},
                              "bfloat16": {"max_abs_err": errs["gwc_bwd"]["middlebury bf16"],
                                           **bwd_t["middlebury bf16"]}},
        ),
        kernel_entry(
            "conv3d", "dcanet_tpu_torch/csrc/conv3d.cu", "dcanet_tpu/kernels/conv3d.py:54", conv_launches["f32"],
            {"conv3d_path": conv_launches["f32"]}, errs["conv3d"]["32->32 f32"], conv_t["32->32 f32"],
            dtype="float32", units="tensor cores (mma.sync m16n8k8 TF32, 3xTF32 split)",
            shape={"x": list(CONV_SHAPE), "out_channels": 32},
            **{"64->32": {"x": list(CONV_SHAPE_64), "max_abs_err": errs["conv3d"]["64->32 f32 scale+bias+relu"],
                          **conv_t["64->32 f32"]}},
        ),
        kernel_entry(
            "conv3d_bf16", "dcanet_tpu_torch/csrc/conv3d.cu", "dcanet_tpu/kernels/conv3d.py:54", conv_launches["bf16"],
            {"conv3d_path": conv_launches["bf16"]}, errs["conv3d"]["32->32 bf16 scale+bias+relu"],
            conv_t["32->32 bf16"], dtype="bfloat16", units="tensor cores (mma.sync)",
            shape={"x": list(CONV_SHAPE), "out_channels": 32},
            **{"64->32": {"x": list(CONV_SHAPE_64), "max_abs_err": errs["conv3d"]["64->32 bf16"],
                          **conv_t["64->32 bf16"]}},
        ),
    ]
    log("[train] summary: " + json.dumps({k: train[k] for k in ("ms", "pairs_per_s", "peak_bytes", "alone")}
                                         | {"parity": parity}))
    log("[eval] summary: " + json.dumps(evaluation))
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
