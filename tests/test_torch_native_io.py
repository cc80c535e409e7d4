"""The port's native PNG decoder (dcanet_tpu_torch/data/native.py over
csrc/stereoio.cpp) and its `read_image` / `read_disparity` against the JAX
package's (dcanet_tpu/data/native.py over libpng, and dcanet_tpu/data/io.py
with its PIL fallback), bit for bit, on the CPU.

Files come from a small numpy encoder here (`_encode`), independent of the
port's writer: every colour type and bit depth (1/2/4-bit grey and
palettes, 16-bit grey, grey + alpha, RGB and RGBA), palettes with and
without tRNS and of grey values, each with filter 0, 1, 2, 3 or 4 on every
row or the five in turn, plain and Adam7-interlaced, at odd widths (13 and
3, where Adam7 has empty passes), in three IDAT chunks or one.

Where the JAX package cannot read a form, the port is held to the written
pixels instead:
- JAX's `native.read_image_f32` sizes its output by the file's samples per
  pixel before libpng's transforms, so it raises for palette images (3
  samples out, 1 in) and returns grey + alpha and RGBA images in a buffer
  of 2 or 4 channels whose stripped samples fill the front and whose rest is
  uninitialised memory. JAX's `read_disparity` then reads that memory for
  grey + alpha and RGBA files. The port's reader gives the decoded form
  ((H, W) grey, (H, W, 3) colour, alpha dropped), and its `read_disparity`
  gives the grey channel or the red one.
- JAX's `read_image` for those forms goes through PIL and is compared as
  it is.

Also: PFM files, little- and big-endian; `normalize_imagenet` against the
JAX library (1 ulp; both fuse x / 255 - mean into one multiply-add, the
JAX one through -march=native) and against the numpy formula
(tests/test_native_io.py's rtol 1e-5); truncated and corrupt files raising and naming the file; the
library's first load and the decodes from 8 threads at once equal to one
thread's; the port's writer (libpng's filter heuristic, round trips
through both readers and PIL, a procedural KITTI scene's mixed filters);
the source's includes and the build's failure raising.
"""

import concurrent.futures
import re
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dcanet_tpu.data import io as jio
from dcanet_tpu.data import native as jnative
from dcanet_tpu_torch.data import io as tio
from dcanet_tpu_torch.data import native as tnative
from dcanet_tpu_torch.data.synthetic import write_procedural_kitti_tree
from dcanet_tpu_torch.kernels import build

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings("ignore:Palette images with Transparency")

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, spp) integer samples -> (h, row bytes) uint8, sub-byte samples
    first in the high bits, each row padded to a byte."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat.astype(np.uint8), ((0, 0), (0, -flat.shape[1] % per)))
    shifts = (8 - depth * np.arange(1, per + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(flat.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, types) -> bytes:
    """Each row with its filter type byte, filtered row by row in Python ints."""
    out, prev = [], [0] * rows.shape[1]
    for y, row in enumerate(rows.tolist()):
        t = types[y % len(types)]
        f = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if t == 0:
                pred = 0
            elif t == 1:
                pred = a
            elif t == 2:
                pred = b
            elif t == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            f.append((x - pred) & 0xFF)
        out.append(bytes([t] + f))
        prev = row
    return b"".join(out)


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", zlib.crc32(ctype + payload))


def _encode(samples, depth, color, types=(0,), interlace=0, palette=None, trns=None, n_idat=3, raw=None) -> bytes:
    """PNG bytes of integer samples (h, w) or (h, w, spp); `raw` replaces
    the filtered stream."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    assert spp == _SAMPLES[color]
    bpp = max(1, spp * depth // 8)
    if raw is None:
        subs = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7] if interlace else [samples]
        raw = b"".join(_filter(_pack(s, depth), bpp, types) for s in subs if s.size)
    z = zlib.compress(raw, 6)
    cuts = np.linspace(0, len(z), n_idat + 1).astype(int)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += b"".join(_chunk(b"IDAT", z[a:b]) for a, b in zip(cuts[:-1], cuts[1:]))
    return out + _chunk(b"IEND", b"")


def _grey_palette(n):
    v = np.linspace(0, 255, n).astype(np.uint8)
    return np.stack([v, v, v], axis=1)


# name -> bit depth, colour type, palette entries (0: none), tRNS, samples' upper bound
FORMS = {
    "gray8": (8, 0, 0, None, 256),
    "gray_alpha8": (8, 4, 0, None, 256),
    "rgb8": (8, 2, 0, None, 256),
    "rgba8": (8, 6, 0, None, 256),
    "rgb8_trns": (8, 2, 0, b"\x00\x01\x00\x02\x00\x03", 256),
    "palette8": (8, 3, 200, None, 200),
    "palette8_trns": (8, 3, 200, bytes(range(0, 250, 5)), 200),
    "palette4_gray": (4, 3, -16, None, 16),
    "palette2_trns": (2, 3, 4, b"\x00\x80", 4),
    "palette1": (1, 3, 2, None, 2),
    "gray1": (1, 0, 0, None, 2),
    "gray2": (2, 0, 0, None, 4),
    "gray4": (4, 0, 0, b"\x00\x05", 16),
    "gray16": (16, 0, 0, None, 65536),
    "rgb16": (16, 2, 0, None, 65536),
    "rgb16_in_8_bits": (16, 2, 0, None, 256),
    "gray_alpha16": (16, 4, 0, None, 65536),
    "rgba16": (16, 6, 0, None, 65536),
}
FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,), "paeth": (4,), "mixed": (0, 1, 2, 3, 4)}


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library (native/, libpng) is not buildable here")
    return jnative


def _decoded(form: str, samples: np.ndarray, palette) -> np.ndarray:
    """The decoded form of the written samples: grey (H, W), colour (H, W, 3)."""
    depth, color = FORMS[form][:2]
    if color == 3:
        return palette[samples[..., 0]].astype(np.float32)
    if color in (0, 4):
        scale = 255 // (2**depth - 1) if depth < 8 else 1
        return (samples[..., 0] * scale).astype(np.float32)
    return samples[..., :3].astype(np.float32)


@pytest.mark.parametrize("filters", sorted(FILTERS))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_matches_jax(tmp_path, rng, jax_native, form, filters):
    depth, color, entries, trns, top = FORMS[form]
    for hw, n_idat in (((11, 13), 3), ((5, 3), 1)):
        for interlace in (0, 1):
            samples = rng.integers(0, top, (*hw, _SAMPLES[color]))
            palette = None
            if entries:
                palette = _grey_palette(-entries) if entries < 0 else rng.integers(0, 256, (entries, 3))
            path = tmp_path / f"{form}_{filters}_{hw[1]}_{interlace}.png"
            path.write_bytes(_encode(samples, depth, color, FILTERS[filters], interlace, palette, trns, n_idat))
            p = str(path)
            want = _decoded(form, samples, palette)
            got = tnative.read_image_f32(p)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            assert tnative.image_info(p) == jax_native.image_info(p)
            if color not in (3, 4, 6):  # the forms the JAX library reads (module docstring)
                np.testing.assert_array_equal(got, jax_native.read_image_f32(p))
            got, ref = tio.read_image(p), jio.read_image(p)
            assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (*hw, 3)
            np.testing.assert_array_equal(got, ref)
            got = tio.read_disparity(p)
            if color in (4, 6):  # JAX reads uninitialised memory here (module docstring)
                first = want if want.ndim == 2 else want[..., 0]
                np.testing.assert_array_equal(got, first / 256.0 if first.max() > 1024 else first)
            else:
                ref = jio.read_disparity(p)
                assert got.dtype == ref.dtype == np.float32
                np.testing.assert_array_equal(got, ref)
            if depth >= 8 and color != 3 and not interlace:  # the plain reader's forms
                np.testing.assert_array_equal(tio.read_png(p), samples[..., 0] if samples.shape[2] == 1 else samples)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("endian", ["<", ">"])
def test_pfm_matches_jax(tmp_path, rng, jax_native, channels, endian):
    data = rng.standard_normal((7, 9, channels) if channels == 3 else (7, 9)).astype(np.float32) * 100
    data[2, 3] = np.inf
    path = tmp_path / "d.pfm"
    with open(path, "wb") as f:
        f.write(b"PF\n" if channels == 3 else b"Pf\n")
        f.write(b"9 7\n" + (b"-1.0\n" if endian == "<" else b"1.0\n"))
        f.write(np.flipud(data).astype(endian + "f4").tobytes())
    p = str(path)
    assert tnative.image_info(p) == jax_native.image_info(p) == (7, 9, channels, 32)
    np.testing.assert_array_equal(tnative.read_image_f32(p), jax_native.read_image_f32(p))
    np.testing.assert_array_equal(tnative.read_image_f32(p), data)
    got, ref = tio.read_disparity(p), jio.read_disparity(p)
    assert got.dtype == ref.dtype == np.float32 and got[2, 3] == 0.0
    np.testing.assert_array_equal(got, ref)


def test_normalize_imagenet(rng, jax_native):
    img = (rng.random((37, 41, 3)) * 255).astype(np.float32)
    img[0, 0] = (0.0, 255.0, 128.0)
    got = tnative.normalize_imagenet(img)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_max_ulp(got, jax_native.normalize_imagenet(img), maxulp=1)
    np.testing.assert_allclose(got, (img / 255.0 - tio.IMAGENET_MEAN) / tio.IMAGENET_STD, rtol=1e-5, atol=1e-6)


def _corrupt(kind: str, rng) -> bytes:
    samples = rng.integers(0, 256, (9, 11, 3))
    good = _encode(samples, 8, 2, (4,), n_idat=1)
    idat_at = good.index(b"IDAT") - 4
    if kind == "signature":
        return b"\x88" + good[1:]
    if kind == "cut_in_header":
        return good[:20]
    if kind == "cut_in_data":
        return good[: idat_at + 40]
    if kind == "header_crc":
        return good[:16] + bytes([good[16] ^ 1]) + good[17:]
    if kind == "data_crc":
        return good[: idat_at + 20] + bytes([good[idat_at + 20] ^ 0x40]) + good[idat_at + 21 :]
    if kind == "filter_byte":
        raw = bytearray(zlib.decompress(good[idat_at + 8 : -16]))
        raw[3 * (1 + 33)] = 5  # row 3's filter type
        return _encode(samples, 8, 2, raw=bytes(raw), n_idat=1)
    if kind == "short_data":
        return _encode(samples, 8, 2, raw=zlib.decompress(good[idat_at + 8 : -16])[:-34], n_idat=1)
    if kind == "not_deflate":  # valid chunks around an IDAT of zeros
        return good[:idat_at] + _chunk(b"IDAT", bytes(40)) + _chunk(b"IEND", b"")
    if kind == "no_palette":
        return _encode(samples[..., :1] % 4, 8, 3, n_idat=1)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["signature", "cut_in_header", "cut_in_data", "header_crc", "data_crc",
                                  "filter_byte", "short_data", "not_deflate", "no_palette"])
def test_corrupt_file_raises(tmp_path, rng, kind):
    path = tmp_path / f"bad_{kind}.png"
    path.write_bytes(_corrupt(kind, rng))
    for read in (tnative.read_image_f32, tio.read_image, tio.read_disparity):
        with pytest.raises(OSError, match=re.escape(str(path))):
            read(path)


def test_decode_threads_equal_one_thread(tmp_path, rng, monkeypatch):
    """The loader's decode pool of 8 threads gives the arrays one thread
    gives; the first load of the library happens inside the pool."""
    paths = []
    for i, (form, filters) in enumerate([(f, t) for f in ("rgb8", "gray16", "palette8", "rgba8") for t in FILTERS]):
        depth, color, entries, trns, top = FORMS[form]
        path = tmp_path / f"{i}.png"
        palette = rng.integers(0, 256, (entries, 3)) if entries else None
        samples = rng.integers(0, top, (48, 67, _SAMPLES[color]))
        path.write_bytes(_encode(samples, depth, color, FILTERS[filters], i % 2, palette, trns))
        paths.append(str(path))
    one = [tio.read_image(p) for p in paths] + [tio.read_disparity(p) for p in paths]
    monkeypatch.setattr(tnative, "_lib", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futures = [pool.submit(tio.read_image, p) for p in paths * 3]
            futures += [pool.submit(tio.read_disparity, p) for p in paths * 3]
            many = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    n = len(paths)
    for k, got in enumerate(many):
        np.testing.assert_array_equal(got, one[(k // (3 * n)) * n + k % n])


def _filter_types(png: bytes) -> np.ndarray:
    """The filter type byte of each row of a non-interlaced 8-bit PNG."""
    w, h, depth, color = struct.unpack(">IIBB", png[16:26])
    idat, pos = b"", 8
    while pos < len(png):
        n, ctype = struct.unpack(">I4s", png[pos : pos + 8])
        if ctype == b"IDAT":
            idat += png[pos + 8 : pos + 8 + n]
        pos += 12 + n
    stride = 1 + w * _SAMPLES[color] * depth // 8
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, stride)[:, 0]


def _libpng_choice(body: np.ndarray, bpp: int) -> list:
    """libpng's default filter heuristic, row by row in Python ints: the
    least sum of |byte read as signed| over the five filters, the first of
    equals."""
    choice = []
    for y in range(body.shape[0]):
        rows = body[max(y - 1, 0) : y + 1]  # row y and the row above it
        sums = []
        for t in range(5):
            filtered = _filter(rows, bpp, [t])[-body.shape[1] :]
            sums.append(sum(v if v < 128 else 256 - v for v in filtered))
        choice.append(int(np.argmin(sums)))
    return choice


def test_writer_follows_libpng_heuristic(rng):
    y, x = np.mgrid[0:40, 0:17]
    img = np.stack([(3 * x + 5 * y) % 256, (x * y) % 256, rng.integers(0, 256, (40, 17))], axis=-1)
    img[20:] = img[20:] // 64  # flat rows favour None / Up
    img = img.astype(np.uint8)
    want = _libpng_choice(img.reshape(40, -1), 3)
    got = _filter_types(tio._encode_png(img)).tolist()
    assert got == want
    assert len(set(got)) >= 3


@pytest.mark.parametrize("kind", ["gray8", "gray_alpha8", "rgb8", "rgba8", "gray16"])
def test_writer_round_trip(tmp_path, rng, jax_native, kind):
    channels = {"gray8": 1, "gray_alpha8": 2, "rgb8": 3, "rgba8": 4, "gray16": 1}[kind]
    dtype = np.uint16 if kind == "gray16" else np.uint8
    y, x = np.mgrid[0:300, 0:13]  # 300 rows: the encoder's blocks of 256 rows
    img = (x[..., None] * 7 + y[..., None] * 3 + rng.integers(0, 9, (300, 13, channels))) * (257 if dtype == np.uint16 else 1)
    img = (img % (np.iinfo(dtype).max + 1)).astype(dtype)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / f"{kind}.png"
    tio.write_png(path, img)
    assert len(set(_filter_types(path.read_bytes()).tolist())) >= 2
    decoded = (img if img.ndim == 2 else img[..., 0] if channels == 2 else img[..., :3]).astype(np.float32)
    np.testing.assert_array_equal(tnative.read_image_f32(path), decoded)
    if channels in (1, 3):
        np.testing.assert_array_equal(jax_native.read_image_f32(str(path)), decoded)
    np.testing.assert_array_equal(tio.read_png(path), img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im).astype(dtype), img)


def test_procedural_kitti_scene_mixes_filters(tmp_path):
    """libpng's heuristic on a procedural scene: Paeth rows in every image
    (with a few Sub rows), Sub and Up rows in the uint16 gt; three filter
    types among the scene's files."""
    root = write_procedural_kitti_tree(tmp_path / "k", "kitti2015", 1, hw=(96, 320), seed=3, workers=1)
    seen = set()
    for sub in ("image_2", "image_3", "disp_occ_0"):
        (png,) = sorted((root / sub).glob("*.png"))
        types = set(_filter_types(png.read_bytes()).tolist())
        assert sub == "disp_occ_0" or 4 in types, (sub, types)
        seen |= types
    assert len(seen) >= 3, seen


def test_source_uses_the_standard_library_alone():
    source = (build.CSRC / "stereoio.cpp").read_text()
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", source, re.M)
    assert includes and all("." not in name for name in includes), includes  # <cstdint> etc., no png.h / zlib.h
    path = build.library_path("stereoio")
    assert path.parent == build.BUILD_DIR and re.fullmatch(r"libstereoio_[0-9a-f]{16}\.so", path.name)


def test_failed_build_raises(tmp_path, rng, monkeypatch):
    """No fallback: with no working compiler the readers raise."""
    path = tmp_path / "x.png"
    path.write_bytes(_encode(rng.integers(0, 256, (4, 5, 3)), 8, 2))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    for read in (tio.read_image, tio.read_disparity):
        with pytest.raises(RuntimeError, match="native build failed"):
            read(path)
