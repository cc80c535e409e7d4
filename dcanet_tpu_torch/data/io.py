"""Image and disparity IO without PIL.

`read_image` and `read_disparity` (the counterparts of
dcanet_tpu/data/io.py:59-112) decode PNGs through the native decoder
(data/native.py) and give what the JAX package's give for every PNG form.
`read_png` is the plain numpy + zlib reader that the tests and the smoke's
checks hold the native decoder to: 8- and 16-bit samples, grayscale /
gray+alpha / RGB / RGBA, non-interlaced, filter types 0-4; no path calls it.
PNG writer: 8-bit gray/RGB/RGBA and 16-bit grayscale, which carries the
KITTI uint16 x256 disparity format (my_img.py:105-110), each row's filter
chosen as libpng's default heuristic chooses it. PFM reader and writer, and
the ImageNet normalisation the training pipeline uses.
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


def _filter_rows(body: np.ndarray, bpp: int, above: np.ndarray) -> np.ndarray:
    """The five PNG filters (None, Sub, Up, Average, Paeth) of each row of
    `body` (rows, stride) uint8, whose first row has the row `above` it
    (zeros for an image's first row): (5, rows, stride) uint8."""
    x = body.astype(np.int16)
    up = np.concatenate([above.astype(np.int16)[None], x[:-1]])
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up_left = np.zeros_like(x)
    up_left[:, bpp:] = up[:, :-bpp]
    pa, pb, pc = np.abs(up - up_left), np.abs(left - up_left), np.abs(left + up - 2 * up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    return np.stack([x, x - left, x - up, x - ((left + up) >> 1), x - paeth]).astype(np.uint8)


def _encode_png(img: np.ndarray, filters=None) -> bytes:
    """PNG bytes of (H, W) or (H, W, 1|2|3|4) uint8, or (H, W) uint16. Row y
    takes filter `filters[y]`; by default the filter whose bytes, read as
    signed, have the least sum of magnitudes (libpng's default heuristic,
    the first of equals)."""
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
    raw = np.empty((h, body.shape[1] + 1), np.uint8)
    above = np.zeros(body.shape[1], np.uint8)
    for r0 in range(0, h, 256):  # blocks of rows bound the int16 temporaries
        block = body[r0 : r0 + 256]
        candidates = _filter_rows(block, ch * depth // 8, above)
        if filters is None:
            cost = np.abs(candidates.view(np.int8).astype(np.int16)).sum(axis=2, dtype=np.int64)
            chosen = np.argmin(cost, axis=0)
        else:
            chosen = np.asarray(filters)[r0 : r0 + len(block)]
        raw[r0 : r0 + len(block), 0] = chosen
        raw[r0 : r0 + len(block), 1:] = candidates[chosen, np.arange(len(block))]
        above = block[-1]

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)

    # libpng's defaults for filtered rows: level 6, the Z_FILTERED strategy
    deflate = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FILTERED)
    idat = deflate.compress(raw) + deflate.flush()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return _SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat) + chunk(b"IEND", b"")


def write_png(path: PathLike, img: np.ndarray) -> None:
    """Encode (H, W) or (H, W, 1|2|3|4) uint8, or (H, W) uint16, as PNG, each
    row's filter chosen as libpng's default heuristic chooses it."""
    png = _encode_png(img)
    with open(path, "wb") as f:
        f.write(png)


def read_image(path: PathLike) -> np.ndarray:
    """A PNG as float32 (H, W, 3) in [0, 255], as the JAX package's
    `read_image` gives it: libpng's decode where that is an RGB image within
    [0, 255], else PIL's convert("RGB"), which replicates grey, drops alpha,
    looks palettes up, clips 16-bit grey at 255 and keeps the high byte of
    other 16-bit samples."""
    from dcanet_tpu_torch.data import native

    img = native.read_image_f32(path)
    _, _, channels, depth = native.image_info(path)
    if depth == 16 and not (channels == 3 and img.max() <= 255):
        img = np.minimum(img, 255) if channels == 1 else np.floor_divide(img, 256)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def normalize_imagenet(img255: np.ndarray) -> np.ndarray:
    """[0, 255] -> ImageNet-normalised float32 (the reference's ToTensor+Normalize)."""
    return (img255 / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def write_kitti_submission_png(path: PathLike, disp: np.ndarray) -> None:
    """uint16 PNG x256, the KITTI benchmark server format."""
    write_png(path, np.clip(disp * 256.0, 0, 65535).astype(np.uint16))


def read_pfm_header(f, path: PathLike) -> Tuple[bool, int, int, float]:
    """(colour, width, height, scale) of the PFM open as `f`, left at its data."""
    header = f.readline().rstrip()
    if header not in (b"PF", b"Pf"):
        raise ValueError(f"not a PFM file: {path}")
    dims = f.readline()
    while dims.startswith(b"#"):  # comments permitted by the spec
        dims = f.readline()
    m = re.match(rb"^\s*(\d+)\s+(\d+)\s*$", dims)
    if not m:
        raise ValueError(f"malformed PFM dims in {path}: {dims!r}")
    return header == b"PF", int(m.group(1)), int(m.group(2)), float(f.readline().rstrip())


def read_pfm(path: PathLike) -> Tuple[np.ndarray, float]:
    """Spec-compliant PFM reader. Returns (data, scale); data is float32
    (H, W) or (H, W, 3), top row first (PFM stores bottom-up)."""
    with open(path, "rb") as f:
        color, width, height, scale = read_pfm_header(f, path)
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
    when uint16-encoded (max > 1024, the KITTI convention); the first channel
    of a colour PNG and the indices of a palette PNG, as the JAX package
    reads them; inf -> 0 (Middlebury)."""
    from dcanet_tpu_torch.data import native

    disp = native.read_image_f32(path, palette_index=True)
    if disp.ndim == 3:
        disp = disp[..., 0]
    if not str(path).endswith(".pfm") and disp.max() > 1024:
        disp = disp / 256.0
    return np.ascontiguousarray(np.where(np.isinf(disp), 0.0, disp), np.float32)
