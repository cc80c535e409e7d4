"""Build and load the port's native libraries: its CUDA kernels and its host code.

Each source `dcanet_tpu_torch/csrc/<name>.cu` exposes a plain C interface and
is compiled by `nvcc` for `sm_90a` into its own shared library, loaded with
`ctypes`. Each host source `csrc/<name>.cpp` (the PNG decoder) is compiled
the same way by the host compiler (`$CXX`, else `c++` or `g++` on `$PATH`),
without `-march=native`: the hash does not name the host CPU. Nothing is
built at import: the first call of `load(name)` builds the library from the
checkout's sources into `dcanet_tpu_torch/_build/` (listed in
`.gitignore`). A library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a stale library is never loaded.
`build()` starts one compiler per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("gwc", "conv3d")  # csrc/<name>.cu, built by nvcc
HOST_LIBRARIES = ("stereoio",)  # csrc/<name>.cpp, built by the host compiler
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "$PATH): the port's CUDA kernels are built from source at first use"
        )
    return found


def cxx() -> list:
    """The host C++ compiler's command: $CXX, else c++ or g++ on $PATH."""
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found is not None:
            return [found]
    raise RuntimeError(
        "no host C++ compiler (looked at $CXX, then c++ and g++ on $PATH): the "
        "port's PNG decoder (csrc/stereoio.cpp) is built from source at first use"
    )


def _source_and_flags(name: str) -> tuple:
    if name in HOST_LIBRARIES:
        return CSRC / f"{name}.cpp", CXX_FLAGS
    if name in KERNELS:
        return CSRC / f"{name}.cu", NVCC_FLAGS
    raise ValueError(f"unknown native library {name!r}: not one of {KERNELS + HOST_LIBRARIES}")


def library_path(name: str) -> Path:
    source, flags = _source_and_flags(name)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named libraries (default: every kernel and host library)
    that are not built yet, one compiler process per source, all started
    together. Returns, per library, the build's wall seconds (0.0 if it was
    already built) and the compiler's output (for a kernel, ptxas register
    and spill counts). Raises if any build fails."""
    names = tuple(KERNELS + HOST_LIBRARIES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "log": "", "path": str(target)}
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        source, flags = _source_and_flags(name)
        compiler = cxx() if name in HOST_LIBRARIES else [nvcc()]
        cmd = [*compiler, *flags, "-o", str(tmp), str(source)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
        )
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} ({Path(proc.args[0]).name} exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {
            "seconds": time.perf_counter() - t0, "log": log, "path": str(target)
        }
    if failed:
        raise RuntimeError("native build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The named library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(target))
    return lib
