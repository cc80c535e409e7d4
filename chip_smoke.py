#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (dcanet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device and build: the card's name and power limit (nvidia-smi); every
     CUDA kernel built from the checkout's sources, one nvcc per source.
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at edge cases, TF32 off; CUDA-event times of
     kernel and plain version beside the card's bound for the same work.
  3. model: DCANet(num_cva=3, maxdisp=192) eval on one 1x3x384x1248 pair,
     weights from `weights.from_jax_variables` on seeded numpy arrays, in bf16
     autocast and in f32; output shape, finiteness, one gwc launch per forward,
     ms/pair, pairs/s, peak memory; and the GPU model against the CPU model
     (plain gwc) on a small input.
  4. serving: three `cli infer --submission` requests on a synthetic
     KITTI-sized PNG pair; the launch counts of this phase are the main path's.
  5. summary: the card's name and power limit, one `{"kernels": [...]}` line,
     and last `{"ok": true, "device": {...}}`.

Needs CUDA: without a card it exits 1 before printing any result. It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
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
SEED = 0
MAIN_SHAPE = (1, 320, 96, 312)  # gwc features of a 384x1248 pair
MAIN_GROUPS, MAIN_D = 40, 48
KITTI_HW = (375, 1242)  # a KITTI 2015 image, padded to 384x1248 by --submission


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
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def phase_kernels():
    """gwc kernel vs its plain version; returns the numbers for the kernels line."""
    import torch

    from dcanet_tpu_torch.kernels import gwc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # f32: the kernel and the plain version differ only in summation order.
    # bf16: both sum in f32 and round once to bf16, so they differ by at most
    # one bf16 ulp (2^-7 relative).
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0**-7)}
    cases = [
        ("main f32", MAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("main bf16", MAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("D=60 f32", MAIN_SHAPE, MAIN_GROUPS, 60, torch.float32),
        ("D>W f32", (2, 16, 5, 7), 4, 12, torch.float32),
        ("D>W bf16", (2, 16, 5, 7), 4, 12, torch.bfloat16),
    ]
    errs = {}
    for name, shape, groups, d, dtype in cases:
        left = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        right = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        got = gwc.gwc_volume_cuda(left, right, d, groups)
        want = gwc.gwc_volume_reference(left, right, d, groups)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"[kernels] gwc {name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs()
        atol, rtol = tol[dtype]
        bad = int((err > atol + rtol * want.float().abs()).sum())
        errs[name] = float(err.max())
        log(f"[kernels] gwc {name} {tuple(shape)} G={groups} D={d}: max|err| {errs[name]:.3e} "
            f"(atol {atol:g}, rtol {rtol:g}), {bad} elements outside")
        if bad:
            raise AssertionError(f"gwc kernel disagrees with its plain version in case {name}")

    flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB > 50 MB L2
    timing = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        left = torch.randn(MAIN_SHAPE, generator=gen, device="cuda").to(dtype)
        right = torch.randn(MAIN_SHAPE, generator=gen, device="cuda").to(dtype)
        ms = time_cuda(lambda: gwc.gwc_volume_cuda(left, right, MAIN_D, MAIN_GROUPS), 20, flush=flush)
        plain_ms = time_cuda(lambda: gwc.gwc_volume_reference(left, right, MAIN_D, MAIN_GROUPS), 5, flush=flush)
        bound_ms, bound_by = gwc_bound_ms(MAIN_SHAPE, MAIN_GROUPS, MAIN_D, left.element_size())
        timing[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernels] gwc main {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")
    return errs, timing


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
    left one shifted by a disparity that grows down the image."""
    rng = np.random.default_rng(seed)
    h, w = KITTI_HW
    pad = 96
    base = rng.integers(0, 256, size=(h // 4 + 1, (w + pad) // 4 + 1, 3)).astype(np.float32)
    tex = np.repeat(np.repeat(base, 4, axis=0), 4, axis=1)[:h, : w + pad]
    left = tex[:, pad:]
    right = np.empty_like(left)
    for y in range(h):
        d = 8 + (80 * y) // h
        right[y] = tex[y, pad - d : pad - d + w]
    return left.astype(np.uint8), right.astype(np.uint8)


def profile_forward(fwd, tag: str, top: int = 6) -> None:
    """One profiled forward: the sum of kernel time against the forward's
    wall time (the device's busy share), and the kernels that take most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"[profile {tag}] the profiler recorded no device time")
        return
    log(f"[profile {tag}] kernels {busy_ms:.3f} ms of a {wall_ms:.3f} ms profiled forward "
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
        profile_forward(fwd, tag)
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


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

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
    errs, timing = phase_kernels()

    from dcanet_tpu_torch.models import DCANet

    flat = seeded_flax_variables(DCANet(maxdisp=192, num_cva=3), SEED)
    _, ref_disp = phase_model(flat)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_serving(flat, ref_disp, Path(tmp))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    f32, bf16 = timing["f32"], timing["bf16"]
    kernels = [{
        "name": "gwc_volume", "route": "cuda", "source": "dcanet_tpu_torch/csrc/gwc.cu",
        "replaces": "dcanet_tpu/kernels/gwc.py:51", "launches": launches,
        "max_abs_err": errs["main f32"], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"], "library_ms": None,
        "dtype": "float32", "shape": {"features": list(MAIN_SHAPE), "groups": MAIN_GROUPS, "maxdisp": MAIN_D},
        "bfloat16": {"max_abs_err": errs["main bf16"], **bf16},
    }]
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
