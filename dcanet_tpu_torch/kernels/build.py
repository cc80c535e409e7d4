"""Build and load the port's CUDA kernels.

Each source `dcanet_tpu_torch/csrc/<name>.cu` exposes a plain C interface and
is compiled by `nvcc` for `sm_90a` into its own shared library, loaded with
`ctypes`. Nothing is built at import: the first call of `load(name)` builds
the library from the checkout's sources into `dcanet_tpu_torch/_build/`
(listed in `.gitignore`). A library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a stale library is never
loaded. `build()` starts one `nvcc` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("gwc", "conv3d")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns, per kernel, the
    build's wall seconds (0.0 if it was already built) and nvcc's output
    (ptxas register and spill counts). Raises if any build fails."""
    names = tuple(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "log": "", "path": str(target)}
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {
            "seconds": time.perf_counter() - t0, "log": log, "path": str(target)
        }
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(target))
    return lib
