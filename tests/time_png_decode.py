"""Times the port's PNG readers against the JAX package's libpng reader on
the same files, on this machine's CPU (not a test; pytest does not collect
it):

    python tests/time_png_decode.py

Files (RGB, 8-bit, a procedural KITTI scene at 376x1248 and the same scene
upsampled to MiddEval3's 1988x2880): every row Paeth, every row Average,
written by PIL (Sub and Up rows), and written by the port's `write_png`
(libpng's filter heuristic). For each: the port's `read_image` (the native
decoder) and its plain `read_png` (numpy, not at 1988x2880), the JAX
package's `native.read_image_f32`, ms, median of 5 (plain: of 1); then 8
Paeth files on an 8-thread pool, as the loader's decode pool reads them.
Every decode is checked against the written pixels.
"""

import concurrent.futures
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dcanet_tpu.data import native as jnative  # noqa: E402
from dcanet_tpu_torch.data import io as tio  # noqa: E402
from dcanet_tpu_torch.data.synthetic import _resize_bilinear, procedural_scene  # noqa: E402


def median_ms(fn, runs: int) -> float:
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main() -> None:
    if not jnative.available():
        sys.exit("the JAX package's native library (native/, libpng) is not buildable here")
    kitti = procedural_scene(11, 376, 1248)[0]
    mb = np.clip(np.rint(_resize_bilinear(kitti.astype(np.float32), 1988, 2880)), 0, 255).astype(np.uint8)
    print(f"{len(os.sched_getaffinity(0))} usable CPUs")
    print("file | port read_image ms | port plain read_png ms | JAX libpng read ms")
    with tempfile.TemporaryDirectory() as tmp:
        for size, img in (("376x1248", kitti), ("1988x2880", mb)):
            h = img.shape[0]
            for name in ("paeth", "average", "PIL", "write_png"):
                path = Path(tmp) / f"{size}_{name}.png"
                if name == "PIL":
                    Image.fromarray(img).save(path)
                elif name == "write_png":
                    tio.write_png(path, img)
                else:
                    path.write_bytes(tio._encode_png(img, np.full(h, {"paeth": 4, "average": 3}[name])))
                for read in (tio.read_image, jnative.read_image_f32):
                    assert np.array_equal(read(str(path)), img.astype(np.float32)), (path, read)
                port = median_ms(lambda: tio.read_image(path), 5)
                plain = median_ms(lambda: tio.read_png(path), 1) if size == "376x1248" else float("nan")
                jax = median_ms(lambda: jnative.read_image_f32(str(path)), 5)
                print(f"{size} {name} | {port:.1f} | {plain:.1f} | {jax:.1f}")
        paths = [str(Path(tmp) / "376x1248_paeth.png")] * 8
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            port = median_ms(lambda: list(pool.map(tio.read_image, paths)), 5)
            jax = median_ms(lambda: list(pool.map(jnative.read_image_f32, paths)), 5)
        print(f"8 Paeth 376x1248 files, 8 threads | {port:.1f} | - | {jax:.1f}")


if __name__ == "__main__":
    main()
