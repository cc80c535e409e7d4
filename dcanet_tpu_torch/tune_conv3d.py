"""Tile variants of the conv3d tensor-core kernels, timed on one card.

    python -m dcanet_tpu_torch.tune_conv3d [--dtype bf16|f32] [--variants NAME,...]

Each variant is `csrc/conv3d.cu` with some constants of one kernel replaced:
the bf16 kernel (namespace `tc`) or the f32 3xTF32 kernel (namespace
`tf32x3`); `TH`, `TW`, `MT`, `kThreads` and the blocks per SM of its launch
bound, or a textual change of its code. All are built at once, one nvcc
each, into a temporary directory. Each is held against the plain version on
a ragged shape and on the main one (f32: the f32 tolerance 1e-5 * max(1,
max|ref|); bf16: one ulp on top of it), then timed with CUDA events, L2
cold, at (1, C, 48, 96, 312) -> 32 for C = 32 and 64, in turns with
F.conv3d (f32 with TF32 off) in the same run. The port builds and runs only
the source as it stands ("current"); the other variants exist only here.
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
BF16_VARIANTS = {
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

# The f32 kernel's shared memory (two stages of 10 x 34 input pixels and
# 2 x 9 x 32 weight rows at 48 bytes) holds 2 blocks of 8 x 32 per SM;
# smaller tiles fit 3. SPLIT_RNA splits the input as the host splits the
# weights, both halves rounded to nearest by cvt.rna.tf32.f32, in place of
# the kernel's split by truncation.
SPLIT_RNA = (
    "  hi = a & 0xffffe000u;\n"
    "  lo = __float_as_uint(__uint_as_float(a) - __uint_as_float(hi));\n",
    "  uint32_t h;\n"
    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(h) : "f"(__uint_as_float(a)));\n'
    "  hi = h & 0xffffe000u;\n"
    '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(__uint_as_float(a) - __uint_as_float(hi)));\n',
)
F32_VARIANTS = {
    "current": {},
    "th8_tw32_lb1": _tile(8, 32, lb=1),
    "th4_tw64": _tile(4, 64),
    "th8_tw16_mt1_lb3": _tile(8, 16, mt=1, lb=3),
    "th4_tw32_128thr_lb3": _tile(4, 32, threads=128, lb=3),
    "th16_tw32_512thr": _tile(16, 32, threads=512, lb=1),
    "th8_tw64_512thr": _tile(8, 64, threads=512, lb=1),
    "th8_tw32_kh_rolled": _tile(8, 32, replace=KH_ROLLED),
    "th8_tw32_split_rna": _tile(8, 32, replace=SPLIT_RNA),
}

# dtype: (namespace, kernel, C function, weight packing, variants, rtol)
KERNELS = {
    "bf16": ("tc", "conv3d_bf16_kernel", "conv3d_bf16", cv.pack_weight_bf16, BF16_VARIANTS, 2.0**-7),
    "f32": ("tf32x3", "conv3d_tf32x3_kernel", "conv3d_f32", cv.pack_weight_tf32x3, F32_VARIANTS, 0.0),
}
SHAPES = ((1, 32, 48, 96, 312), (1, 64, 48, 96, 312))


def variant_source(src: str, consts: dict, ns: str) -> str:
    """`src` with `consts` applied inside `namespace ns { ... }` only."""
    head, rest = src.split(f"namespace {ns} {{", 1)
    body, tail = rest.split(f"}}  // namespace {ns}", 1)
    for name, value in consts.items():
        if name == "replace":
            n = body.count(value[0])
            body = body.replace(*value)
        elif name == "LB":
            body, n = re.subn(r"__launch_bounds__\(kThreads, \d+\)", f"__launch_bounds__(kThreads, {value})", body)
        else:
            body, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", body, count=1)
        if n != 1:
            raise ValueError(f"no {name} in namespace {ns} of the source")
    return head + f"namespace {ns} {{" + body + f"}}  // namespace {ns}" + tail


def build_variants(names, workdir: Path, dtype: str):
    ns, kernel, fname, _, variants, _ = KERNELS[dtype]
    src = (build.CSRC / "conv3d.cu").read_text()
    procs = {}
    for name in names:
        cu, so = workdir / f"{name}.cu", workdir / f"lib{name}.so"
        cu.write_text(variant_source(src, variants[name], ns))
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if f"{kernel}ILb1" in line:
                print(f"[{name}] ptxas: {lines[i + 1].strip()}; {lines[i + 2].strip()}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), fname)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(fn, x, wp, co, scale=None, bias=None, relu=False):
    b, c, d, h, w = x.shape
    out = torch.empty((b, co, d, h, w), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), wp.data_ptr(), None if scale is None else scale.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(), b, c, d, h, w, co,
             int(relu), x.device.index, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def check(name, fn, dtype, x, w, scale, bias, relu) -> float:
    """max |err| of the variant against the plain version; raises outside the tolerance."""
    pack, rtol = KERNELS[dtype][3], KERNELS[dtype][5]
    got = run(fn, x, pack(w), w.shape[0], scale, bias, relu)
    want = cv.conv3d_reference(x, w, scale, bias, relu).float()
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    err = (got.float() - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if bad:
        raise AssertionError(f"variant {name}: {bad} elements off the plain version at {tuple(x.shape)}")
    return float(err.max())


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
    ap.add_argument("--dtype", default="bf16", choices=sorted(KERNELS), help="the kernel to vary")
    ap.add_argument("--variants", default=None, help="comma-separated subset (default: all of the dtype's)")
    args = ap.parse_args(argv)
    pack, variants = KERNELS[args.dtype][3], KERNELS[args.dtype][4]
    names = list(variants) if args.variants is None else args.variants.split(",")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {gpu}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory(prefix="tune_conv3d_") as tmp:
        fns = build_variants(names, Path(tmp), args.dtype)
        errs = dict.fromkeys(fns, 0.0)
        for shape, co in (((1, 24, 3, 10, 33), 64), (SHAPES[0], 32)):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (torch.randn((co, shape[1], 3, 3, 3), generator=gen, device="cuda") * 0.1).to(dtype)
            scale = torch.rand(co, generator=gen, device="cuda") + 0.5
            bias = torch.randn(co, generator=gen, device="cuda") * 0.1
            for name, fn in fns.items():
                errs[name] = max(errs[name], check(name, fn, args.dtype, x, w, scale, bias, True))
        print(f"[check] {len(fns)} {args.dtype} variants agree with the plain version; max|err| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()), flush=True)
        flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB > 50 MB L2
        for shape in SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (torch.randn((32, shape[1], 3, 3, 3), generator=gen, device="cuda") * 0.1).to(dtype)
            wp = pack(w)
            times = {n: [] for n in ["F.conv3d", *fns]}
            for order in (list(fns), list(fns)[::-1]):  # in turns: forward, then backward
                times["F.conv3d"].append(time_ms(lambda: F.conv3d(x, w, padding=1), flush))
                for name in order:
                    times[name].append(time_ms(lambda: run(fns[name], x, wp, 32), flush))
            ref = statistics.mean(times["F.conv3d"])
            for name, ts in times.items():
                print(f"[time] {args.dtype} {shape} -> 32 {name}: " + ", ".join(f"{t:.4f}" for t in ts)
                      + f" ms; mean / F.conv3d {statistics.mean(ts) / ref:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
