"""Tile variants of the bf16 conv3d tensor-core kernel, timed on one card.

    python -m dcanet_tpu_torch.tune_conv3d [--variants NAME,...]

Each variant is `csrc/conv3d.cu` with some constants of the tensor-core
kernel replaced (`tc::TH`, `tc::TW`, `tc::MT`, `tc::kThreads` and the blocks
per SM of its launch bound). All are built at once, one nvcc each, into a
temporary directory. Each is held against the plain version on a ragged
shape and on the main one, then timed with CUDA events, L2 cold, at
(1, C, 48, 96, 312) -> 32 for C = 32 and 64, in turns with F.conv3d in the
same run. The port builds and runs only the source as it stands ("current");
the other variants exist only here.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from dcanet_tpu_torch.kernels import build
from dcanet_tpu_torch.kernels import conv3d as cv

def _tile(th, tw, mt=2, threads=256, lb=2, **extra):
    return {"TH": th, "TW": tw, "MT": mt, "kThreads": threads, "LB": lb, **extra}


KH_ROLLED = ("#pragma unroll\n    for (int kh = 0;", "#pragma unroll 1\n    for (int kh = 0;")

# TH x TW output tile, MT 16-pixel M tiles per warp, threads per block, the
# launch bound's blocks per SM (which caps the registers a thread gets), and
# optionally a textual change of the main loop (the kh loop left rolled)
VARIANTS = {
    "current": {},
    "th4_tw64": _tile(4, 64),
    "th4_tw64_lb1": _tile(4, 64, lb=1),
    "th8_tw32": _tile(8, 32),
    "th8_tw32_lb3": _tile(8, 32, lb=3),
    "th2_tw128": _tile(2, 128),
    "th4_tw32_128thr": _tile(4, 32, threads=128, lb=4),
    "th8_tw64_512thr": _tile(8, 64, threads=512, lb=1),
    "th16_tw32_512thr": _tile(16, 32, threads=512, lb=1),
    "th4_tw64_mt4_128thr": _tile(4, 64, mt=4, threads=128, lb=3),
    "th8_tw64_mt4": _tile(8, 64, mt=4, lb=1),
    "th8_tw16_mt1": _tile(8, 16, mt=1, lb=3),
    "th16_tw16_mt1_512thr": _tile(16, 16, mt=1, threads=512, lb=1),
    "th8_tw32_kh_rolled": _tile(8, 32, replace=KH_ROLLED),
    "th8_tw32_kh_rolled_lb3": _tile(8, 32, lb=3, replace=KH_ROLLED),
}
SHAPES = ((1, 32, 48, 96, 312), (1, 64, 48, 96, 312))


def variant_source(src: str, consts: dict) -> str:
    head, tail = src.split("namespace tc {", 1)
    for name, value in consts.items():
        if name == "replace":
            n = tail.count(value[0])
            tail = tail.replace(*value)
        elif name == "LB":
            tail, n = re.subn(r"__launch_bounds__\(kThreads, \d+\)", f"__launch_bounds__(kThreads, {value})", tail)
        else:
            tail, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", tail, count=1)
        if n != 1:
            raise ValueError(f"no constant {name} in the tensor-core kernel's source")
    return head + "namespace tc {" + tail


def build_variants(names, workdir: Path):
    src = (build.CSRC / "conv3d.cu").read_text()
    procs = {}
    for name in names:
        cu, so = workdir / f"{name}.cu", workdir / f"lib{name}.so"
        cu.write_text(variant_source(src, VARIANTS[name]))
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "conv3d_bf16_kernelILb1" in line:
                print(f"[{name}] ptxas: {lines[i + 1].strip()}; {lines[i + 2].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.conv3d_bf16.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.conv3d_bf16.restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(lib, x, wp, co, scale=None, bias=None, relu=False):
    b, c, d, h, w = x.shape
    out = torch.empty((b, co, d, h, w), dtype=x.dtype, device=x.device)
    err = lib.conv3d_bf16(x.data_ptr(), wp.data_ptr(), None if scale is None else scale.data_ptr(),
                          None if bias is None else bias.data_ptr(), out.data_ptr(), b, c, d, h, w, co,
                          int(relu), x.device.index, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def check(name, lib, x, w, scale, bias, relu):
    got = run(lib, x, cv.pack_weight_bf16(w), w.shape[0], scale, bias, relu)
    want = cv.conv3d_reference(x, w, scale, bias, relu).float()
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    bad = int(((got.float() - want).abs() > atol + 2.0**-7 * want.abs()).sum())
    if bad:
        raise AssertionError(f"variant {name}: {bad} elements off the plain version at {tuple(x.shape)}")


def time_ms(fn, flush, iters=10):
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated subset of %(default)s")
    names = ap.parse_args(argv).variants.split(",")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {gpu}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory(prefix="tune_conv3d_") as tmp:
        libs = build_variants(names, Path(tmp))
        for shape, co in (((1, 24, 3, 10, 33), 64), (SHAPES[0], 32)):
            x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
            w = (torch.randn((co, shape[1], 3, 3, 3), generator=gen, device="cuda") * 0.1).bfloat16()
            scale = torch.rand(co, generator=gen, device="cuda") + 0.5
            bias = torch.randn(co, generator=gen, device="cuda") * 0.1
            for name, lib in libs.items():
                check(name, lib, x, w, scale, bias, True)
        print(f"[check] {len(libs)} variants agree with the plain version", flush=True)
        flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB > 50 MB L2
        for shape in SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
            w = (torch.randn((32, shape[1], 3, 3, 3), generator=gen, device="cuda") * 0.1).bfloat16()
            wp = cv.pack_weight_bf16(w)
            times = {n: [] for n in ["F.conv3d", *libs]}
            for order in (list(libs), list(libs)[::-1]):  # in turns: forward, then backward
                times["F.conv3d"].append(time_ms(lambda: F.conv3d(x, w, padding=1), flush))
                for name in order:
                    times[name].append(time_ms(lambda: run(libs[name], x, wp, 32), flush))
            ref = statistics.mean(times["F.conv3d"])
            for name, ts in times.items():
                print(f"[time] {shape} -> 32 {name}: " + ", ".join(f"{t:.4f}" for t in ts)
                      + f" ms; mean / F.conv3d {statistics.mean(ts) / ref:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
