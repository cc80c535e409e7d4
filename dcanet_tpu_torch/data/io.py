"""Image and disparity IO with numpy and zlib alone (no PIL).

PNG reader: 8- and 16-bit samples, grayscale / gray+alpha / RGB / RGBA,
non-interlaced, filter types 0-4. PNG writer: 8-bit gray/RGB/RGBA and 16-bit
grayscale, which carries the KITTI uint16 x256 disparity format
(my_img.py:105-110). PFM reader and writer and `read_disparity` (copies of
dcanet_tpu/data/io.py:23-112, PNG through the reader here). Also the
ImageNet normalisation the training pipeline uses.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG color type -> samples per pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _unfilter_average(line: bytes, up: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    return bytes(cur)


def _unfilter_paeth(line: bytes, up: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        if i >= bpp:
            a, c = cur[i - bpp], up[i - bpp]
        else:
            a = c = 0
        b = up[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return bytes(cur)


def read_png(path: PathLike) -> np.ndarray:
    """Decode a PNG to (H, W) for one channel, else (H, W, channels); dtype
    uint8 or uint16 by bit depth."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, color, compression, filter_method, interlace = header
    if depth not in (8, 16) or color not in _CHANNELS or compression or filter_method or interlace:
        raise ValueError(
            f"unsupported PNG {path}: bit depth {depth}, color type {color}, interlace {interlace} "
            "(supported: 8/16-bit gray, gray+alpha, RGB, RGBA, non-interlaced)"
        )
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"corrupt PNG {path}: {len(raw)} bytes of image data, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum along each byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:  # Average
            cur = np.frombuffer(_unfilter_average(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif ftype == 4:  # Paeth
            cur = np.frombuffer(_unfilter_paeth(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"corrupt PNG {path}: filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def write_png(path: PathLike, img: np.ndarray) -> None:
    """Encode (H, W) or (H, W, 1|2|3|4) uint8, or (H, W) uint16, as PNG
    (filter type 0 on every row)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1-4), got {img.shape}")
    if img.dtype == np.uint16 and img.shape[2] != 1:
        raise ValueError("16-bit PNGs are written as grayscale only")
    h, w, ch = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    body = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), body], axis=1).tobytes()

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def read_image(path: PathLike) -> np.ndarray:
    """8-bit PNG as float32 (H, W, 3) RGB in [0, 255]; gray is replicated and
    alpha dropped, as PIL's convert("RGB") does."""
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"read_image takes 8-bit images, {path} is 16-bit")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[-1] == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3].astype(np.float32)


def normalize_imagenet(img255: np.ndarray) -> np.ndarray:
    """[0, 255] -> ImageNet-normalised float32 (the reference's ToTensor+Normalize)."""
    return (img255 / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def write_kitti_submission_png(path: PathLike, disp: np.ndarray) -> None:
    """uint16 PNG x256, the KITTI benchmark server format."""
    write_png(path, np.clip(disp * 256.0, 0, 65535).astype(np.uint16))


def read_pfm(path: PathLike) -> Tuple[np.ndarray, float]:
    """Spec-compliant PFM reader. Returns (data, scale); data is float32
    (H, W) or (H, W, 3), top row first (PFM stores bottom-up)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline()
        while dims.startswith(b"#"):  # comments permitted by the spec
            dims = f.readline()
        m = re.match(rb"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM dims in {path}: {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), endian + "f4")
    shape = (height, width, 3) if color else (height, width)
    return np.ascontiguousarray(np.flipud(data.reshape(shape))), abs(scale)


def write_pfm(path: PathLike, data: np.ndarray, scale: float = 1.0) -> None:
    data = np.asarray(data, np.float32)
    with open(path, "wb") as f:
        f.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())  # little-endian
        np.flipud(data).astype("<f4").tofile(f)


def read_disparity(path: PathLike) -> np.ndarray:
    """Disparity as float32 (H, W): .pfm as PFM, else a PNG, divided by 256
    when uint16-encoded (max > 1024, the KITTI convention); inf -> 0
    (Middlebury)."""
    if str(path).endswith(".pfm"):
        disp, _ = read_pfm(path)
    else:
        disp = read_png(path).astype(np.float32)
        if disp.ndim == 3:
            disp = disp[..., 0]
        if disp.max() > 1024:
            disp = disp / 256.0
    return np.ascontiguousarray(np.where(np.isinf(disp), 0.0, disp), np.float32)
