"""The native PNG decoder (csrc/stereoio.cpp) and the ImageNet normalisation.

The port's counterpart of dcanet_tpu/data/native.py, with its API and output
form, without libpng: Python's `zlib.decompress` inflates the joined IDAT
stream and the C++ library checks the chunks, undoes the row filters (all
five, Adam7 pass by pass), expands palettes and sub-byte grey and drops
alpha, writing float32 straight into a numpy array. Every step but reading
the chunk list runs without the interpreter lock (`ctypes.CDLL` releases it
for each call, zlib for the inflate), so the loader's decode threads run in
parallel. The library is built at first use by the host compiler
(kernels/build.py). There is no fallback: a failed build raises, and so does
a file the decoder rejects, naming the file.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from dcanet_tpu_torch.data.io import PathLike, read_pfm, read_pfm_header
from dcanet_tpu_torch.kernels import build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_FILE_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_ERRORS = {  # csrc/stereoio.cpp's status codes
    -1: "not a PNG file",
    -2: "truncated file",
    -3: "CRC mismatch in a critical chunk",
    -4: "bad IHDR",
    -5: "missing or bad PLTE",
    -6: "no IDAT chunk",
    -7: "not enough image data",
    -8: "bad row filter type",
    -9: "output buffer of the wrong size",
    -10: "unknown critical chunk",
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:  # the decode pool's threads may all arrive first at once
        if _lib is None:
            lib = build.load("stereoio")
            p = ctypes.c_void_p
            lib.sio_png_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, p, p, p, p]
            lib.sio_png_parse.restype = ctypes.c_int
            lib.sio_png_reconstruct.argtypes = [ctypes.c_char_p, ctypes.c_int64, p, p, ctypes.c_int, p,
                                                ctypes.c_int64]
            lib.sio_png_reconstruct.restype = ctypes.c_int
            lib.sio_normalize_imagenet.argtypes = [p, p, ctypes.c_int64]
            lib.sio_normalize_imagenet.restype = None
            _lib = lib
        return _lib


def _is_pfm(path: str) -> bool:
    return path.endswith(".pfm")


def image_info(path: PathLike) -> Tuple[int, int, int, int]:
    """(height, width, channels, bit depth) as the file stores them: a PNG's
    samples per pixel before any expansion (palette 1, grey + alpha 2, RGBA
    4); (h, w, 1 or 3, 32) for a PFM."""
    path = str(path)
    with open(path, "rb") as f:
        if _is_pfm(path):
            color, w, h, _ = read_pfm_header(f, path)
            return h, w, 3 if color else 1, 32
        head = f.read(33)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise OSError(f"{path}: not a PNG file")
    w, h, depth, color = struct.unpack(">IIBB", head[16:26])
    if color not in _FILE_CHANNELS:
        raise OSError(f"{path}: bad IHDR (colour type {color})")
    return h, w, _FILE_CHANNELS[color], depth


def read_image_f32(path: PathLike, palette_index: bool = False) -> np.ndarray:
    """Decode a PNG or PFM to float32: (H, W) for grey (and grey + alpha),
    (H, W, 3) for RGB, RGBA and palette images (alpha and tRNS dropped).
    8-bit PNG samples lie in [0, 255], 1/2/4-bit grey is scaled to 8 bits,
    16-bit samples are the raw values; a PFM gives its floats, top row
    first. `palette_index` gives a palette image's indices, (H, W), instead
    of its colours."""
    path = str(path)
    if _is_pfm(path):
        return read_pfm(path)[0]
    lib = _library()
    data = Path(path).read_bytes()
    header = np.zeros(8, np.int64)
    palette = np.zeros(768, np.uint8)
    idat = np.empty(len(data), np.uint8)
    idat_n = ctypes.c_int64(0)
    rc = lib.sio_png_parse(data, len(data), header.ctypes.data, palette.ctypes.data, idat.ctypes.data,
                           ctypes.addressof(idat_n))
    if rc != 0:
        raise OSError(f"{path}: {_ERRORS.get(rc, f'decode error {rc}')}")
    w, h, color = int(header[0]), int(header[1]), int(header[3])
    try:
        raw = zlib.decompress(idat[: idat_n.value], bufsize=int(header[7]))
    except zlib.error as e:
        raise OSError(f"{path}: corrupt image data ({e})") from e
    gray = color in (0, 4) or (color == 3 and palette_index)
    out = np.empty((h, w) if gray else (h, w, 3), np.float32)
    rc = lib.sio_png_reconstruct(raw, len(raw), header.ctypes.data, palette.ctypes.data, int(palette_index),
                                 out.ctypes.data, out.size)
    if rc != 0:
        raise OSError(f"{path}: {_ERRORS.get(rc, f'decode error {rc}')}")
    return out


def normalize_imagenet(img255: np.ndarray) -> np.ndarray:
    """(x / 255 - mean) / std of an (H, W, 3) float32 image, in C++ (the
    counterpart of the JAX package's `sio_normalize_imagenet`)."""
    img255 = np.ascontiguousarray(img255, np.float32)
    if img255.shape[-1] != 3:
        raise ValueError(f"normalize_imagenet takes (..., 3) images, got {img255.shape}")
    out = np.empty_like(img255)
    _library().sio_normalize_imagenet(img255.ctypes.data, out.ctypes.data, img255.size // 3)
    return out
