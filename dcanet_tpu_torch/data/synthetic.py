"""Synthetic datasets in the SceneFlow, KITTI, ETH3D and Middlebury layouts, drawn from a seed:

  SceneFlow   <root>/frames_finalpass/<split>/A/<seq>/{left,right}/<frame>.png
              <root>/frames_disparity/<split>/A/<seq>/left/<frame>.pfm
  KITTI 2015  <root>/{image_2,image_3}/<index:06d>_10.png
              <root>/disp_occ_0/<index:06d>_10.png (uint16, disparity x 256,
              0 where there is no gt)
  ETH3D       <root>/<scene>/{im0.png, im1.png, disp0GT.pfm} (inf where
              there is no gt)

Each left image is a blocky random texture; the right image is the left one
shifted by the disparity (left[y, x] = right[y, x - d]), which grows down the
image (rows of constant disparity between `min_disp` and `max_disp`), so the
pair is consistent with its ground truth. The KITTI gt is sparse as KITTI's
LiDAR gt is: none in the top quarter of the image, and 40 % of the pixels
below it; the ETH3D gt leaves a random tenth of the pixels without a value,
as ETH3D's does. For smoke tests of the training path (`cli train`) and of
the eval path (`cli eval`, `cli infer --list`).

`procedural_scene` draws a scene to learn from, with exact ground truth:
multi-octave value-noise textures on fronto-parallel planes composed
back-to-front in both views in disparity order (consistent occlusions),
fractional disparities between `dmin` and `dmax` rendered by linear column
interpolation; the background shifts with wrap-around, so the right view
has no invalid band. `write_procedural_sceneflow_tree` writes a TRAIN and
a TEST split of them in the SceneFlow layout (`<seq:04d>` = index // 100,
`<frame:04d>` = index % 100), scene i of TRAIN from the seed
seed * 1_000_000 + i and of TEST from seed * 1_000_000 + 500_000 + i. Both
are the port's copy of the JAX package's generator
(tools/gen_synthetic_sceneflow.py), equal to it bit for bit; its training
curve ran on 1600 + 40 such scenes at 320x640 (TRAINCURVE.md).
`write_procedural_kitti_tree` writes such scenes in the KITTI 2012 or 2015
layout (the tool's `--layout kitti2012|kitti2015`), `<index:06d>_10.png`:

  KITTI 2012  <root>/{colored_0,colored_1,disp_occ}/
  KITTI 2015  <root>/{image_2,image_3,disp_occ_0}/

scene i from the seed seed * 1_000_000 + i, its gt sparse as a LiDAR's
(`kitti_sparse_gt`: ~20 % of the pixels dropped at random, and the left band
whose match lies outside the right view), uint16 disparity x 256; the JAX
package's fine-tune leg ran on 120 + 120 such scenes at 376x1248 and scored
24 more (TRAINCURVE.md, FINETUNE.json).
`write_procedural_eth3d_tree` and `write_procedural_middlebury_tree` write
them in the two benchmarks' layout, `<root>/scene<index:04d>/{im0.png,
im1.png, disp0GT.pfm}` (what `data/datasets.py::scan_eth3d` and
`scan_middlebury` read), scene i from the seed seed * 1_000_000 + i, at an
ETH3D two-view frame's 489x941 and a full-resolution MiddEval3 frame's
1988x2880 by default, each with its benchmark's disparity range
(`BENCHMARK_LAYOUTS`), the gt inf where it is unknown, as theirs is
(`unknown_as_inf`).
"""

from __future__ import annotations

import multiprocessing
import os
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from dcanet_tpu_torch.data.io import write_pfm, write_png

KITTI_GT_DENSITY = 0.4


def _shifted_pair(rng: np.random.Generator, disp_rows: np.ndarray, w: int, block: int, pad: int):
    """A blocky random texture (h, w + pad) -> the left image and the right
    one, each row shifted by its disparity."""
    h = len(disp_rows)
    base = rng.integers(0, 256, size=(h // block + 1, (w + pad) // block + 1, 3), dtype=np.uint8)
    tex = np.repeat(np.repeat(base, block, axis=0), block, axis=1)[:h, : w + pad]
    right = np.stack([tex[y, disp_rows[y] : disp_rows[y] + w] for y in range(h)])
    return tex[:, :w], right


def _disp_rows(h: int, min_disp: int, max_disp: int) -> np.ndarray:
    return min_disp + ((max_disp - min_disp) * np.arange(h)) // max(h - 1, 1)


def write_sceneflow_tree(
    root: Union[str, Path], num_pairs: int, hw: Tuple[int, int] = (540, 960), seed: int = 0,
    min_disp: int = 4, max_disp: int = 100, block: int = 4, split: str = "TRAIN",
) -> Path:
    """Write `num_pairs` pairs of size `hw` under `root`, in the FlyingThings3D
    `split` ("TRAIN" or "TEST", which `cli eval --preset sceneflow` reads);
    returns `root`."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    for i in range(num_pairs):
        seq = f"{i // 10:04d}"
        frame = f"{6 + i % 10:04d}"
        img_dir = root / "frames_finalpass" / split / "A" / seq
        disp_dir = root / "frames_disparity" / split / "A" / seq / "left"
        for d in (img_dir / "left", img_dir / "right", disp_dir):
            os.makedirs(d, exist_ok=True)
        disp_rows = _disp_rows(h, min_disp, max_disp)
        left, right = _shifted_pair(rng, disp_rows, w, block, max_disp + 1)
        write_png(img_dir / "left" / f"{frame}.png", left)
        write_png(img_dir / "right" / f"{frame}.png", right)
        write_pfm(disp_dir / f"{frame}.pfm", np.repeat(disp_rows[:, None], w, axis=1).astype(np.float32))
    return root


def write_kitti2015_tree(
    root: Union[str, Path], num_pairs: int, hw: Tuple[int, int] = (375, 1242), seed: int = 0,
    min_disp: int = 4, max_disp: int = 100, block: int = 4,
    out_of_range_pair: Optional[int] = None, maxdisp: int = 192,
) -> Path:
    """Write `num_pairs` pairs of size `hw` under `root`; returns `root`.

    Pair `out_of_range_pair` has the disparity `maxdisp` on all but the
    bottom 1/40 of its rows, so that under 10 % of its gt lies inside the
    eval mask (0 < gt < maxdisp) and the per-image skip rule drops it.
    """
    if max(max_disp, maxdisp) * 256 > np.iinfo(np.uint16).max:
        raise ValueError(f"KITTI's uint16 x256 gt holds disparities below 256, got {max(max_disp, maxdisp)}")
    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(root / sub, exist_ok=True)
    for i in range(num_pairs):
        disp_rows = _disp_rows(h, min_disp, max_disp)
        if i == out_of_range_pair:
            disp_rows = np.where(np.arange(h) < h - h // 40, maxdisp, disp_rows)
        left, right = _shifted_pair(rng, disp_rows, w, block, int(disp_rows.max()) + 1)
        valid = (rng.random((h, w)) < KITTI_GT_DENSITY) & (np.arange(h)[:, None] >= h // 4)
        gt = np.where(valid, disp_rows[:, None] * 256, 0).astype(np.uint16)
        name = f"{i:06d}_10.png"
        write_png(root / "image_2" / name, left)
        write_png(root / "image_3" / name, right)
        write_png(root / "disp_occ_0" / name, gt)
    return root


def write_eth3d_tree(
    root: Union[str, Path], num_pairs: int, hw: Tuple[int, int] = (489, 942), seed: int = 0,
    min_disp: int = 2, max_disp: int = 60, block: int = 4,
) -> Path:
    """Write `num_pairs` scenes of size `hw` under `root` (the ETH3D two-view
    layout, `cli eval --dataset eth3d`); returns `root`."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    for i in range(num_pairs):
        scene = root / f"scene_{i:02d}"
        os.makedirs(scene, exist_ok=True)
        disp_rows = _disp_rows(h, min_disp, max_disp)
        left, right = _shifted_pair(rng, disp_rows, w, block, max_disp + 1)
        gt = np.repeat(disp_rows[:, None], w, axis=1).astype(np.float32)
        gt[rng.random((h, w)) < 0.1] = np.inf
        write_png(scene / "im0.png", left)
        write_png(scene / "im1.png", right)
        write_pfm(scene / "disp0GT.pfm", gt)
    return root


# ---- procedural scenes ----


def _resize_bilinear(a: np.ndarray, h: int, w: int) -> np.ndarray:
    gh, gw = a.shape[:2]
    ys = np.linspace(0, gh - 1, h, dtype=np.float32)
    xs = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    # each grid row interpolated along x once: rows[y0] holds, element for
    # element, the same products and sums as the interpolation of a[y0]
    rows = a[:, x0] * (1 - fx) + a[:, x1] * fx
    return rows[y0] * (1 - fy) + rows[y1] * fy


def _value_noise(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Multi-octave value noise, (h, w, 3) in [0, 1], colourised by a random
    channel mix (the texture stays correlated across RGB)."""
    img = np.zeros((h, w, 3), np.float32)
    amp = 1.0
    for g in (4, 8, 16, 32, 64):
        grid = rng.random((g, g, 3), dtype=np.float32)
        img += amp * _resize_bilinear(grid, h, w)
        amp *= 0.55
    img -= img.min()
    img /= max(float(img.max()), 1e-6)
    mix = 0.5 * np.eye(3, dtype=np.float32) + 0.5 * rng.random((3, 3), dtype=np.float32)
    return np.clip(img @ mix.T, 0.0, 1.0)


def _shift_x(img: np.ndarray, d: float, wrap: bool) -> np.ndarray:
    """img sampled at (x + d) along axis 1 (the right view, d >= 0)."""
    i0 = int(np.floor(d))
    f = np.float32(d - i0)
    if wrap:
        a = np.roll(img, -i0, axis=1)
        b = np.roll(img, -(i0 + 1), axis=1)
    else:
        pad = [(0, 0)] * img.ndim
        pad[1] = (0, i0 + 1)
        padded = np.pad(img, pad)
        a = padded[:, i0: i0 + img.shape[1]]
        b = padded[:, i0 + 1: i0 + 1 + img.shape[1]]
    return a * (1 - f) + b * f


def _shape_mask(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A rotated ellipse or rectangle, (h, w) float 0/1."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = rng.uniform(0.1 * h, 0.9 * h)
    cx = rng.uniform(0.1 * w, 0.9 * w)
    ry = rng.uniform(0.06 * h, 0.28 * h)
    rx = rng.uniform(0.04 * w, 0.22 * w)
    th = rng.uniform(0, np.pi)
    u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
    v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
    if rng.random() < 0.5:
        m = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
    else:
        m = (np.abs(u) <= rx) & (np.abs(v) <= ry)
    return m.astype(np.float32)


def procedural_scene(seed: int, h: int, w: int, dmin: float = 4.0, dmax: float = 88.0):
    """One procedural scene: (left (h, w, 3) uint8, right (h, w, 3) uint8,
    disparity (h, w) float32): a background at a disparity in [dmin,
    dmin + 18) and 4-8 textured shapes at disparities in [dmin + 6, dmax),
    nearer shapes drawn over farther ones in both views."""
    rng = np.random.default_rng(seed)
    d_bg = float(rng.uniform(dmin, dmin + 18.0))
    left = _value_noise(rng, h, w)
    right = _shift_x(left, d_bg, wrap=True)
    disp = np.full((h, w), d_bg, np.float32)
    n_obj = int(rng.integers(4, 9))
    for d in np.sort(rng.uniform(dmin + 6.0, dmax, n_obj)):  # back to front
        d = float(d)
        tex = _value_noise(rng, h, w)
        mask = _shape_mask(rng, h, w)
        m3 = mask[..., None]
        rm = _shift_x(m3, d, wrap=False)
        rt = _shift_x(tex, d, wrap=False)
        left = np.where(m3 > 0.5, tex, left)
        right = np.where(rm > 0.5, rt, right)
        disp = np.where(mask > 0.5, d, disp)

    def to_u8(x):
        return (np.clip(x, 0, 1) * 255.0 + 0.5).astype(np.uint8)

    return to_u8(left), to_u8(right), disp


def procedural_seed(seed: int, split: str, index: int) -> int:
    """The scene seed of `index` in `split` ("TRAIN" or "TEST") of the tree of `seed`."""
    return seed * 1_000_000 + (500_000 if split == "TEST" else 0) + index


KITTI_LAYOUTS = {  # layout -> (left, right, gt) directories
    "kitti2012": ("colored_0", "colored_1", "disp_occ"),
    "kitti2015": ("image_2", "image_3", "disp_occ_0"),
}


def kitti_sparse_gt(disp: np.ndarray, scene_seed: int) -> np.ndarray:
    """A scene's disparity as KITTI's sparse uint16 x 256 gt: a pixel keeps
    its value with probability 0.8 (drawn from `scene_seed + 777`) where its
    match lies inside the right view (x >= d), else 0; the cast truncates."""
    rng = np.random.default_rng(scene_seed + 777)
    xs = np.arange(disp.shape[1])[None, :]
    valid = (rng.random(disp.shape) > 0.2) & (xs >= disp)
    return np.where(valid, np.clip(disp * 256.0, 1, 65535), 0).astype(np.uint16)


# layout -> (full-resolution disparity range of its scenes, share of pixels
# without gt): ETH3D's two-view frames (~490x940, disparities up to ~60,
# sparse laser gt), Middlebury MiddEval3's full-resolution frames (~2000x2900,
# ndisp up to ~800; training halves them, so the upper part lies past the
# preset's maxdisp 240)
BENCHMARK_LAYOUTS = {"eth3d": ((2.0, 64.0), 0.1), "middlebury": ((40.0, 640.0), 0.05)}


def unknown_as_inf(disp: np.ndarray, scene_seed: int, share: float) -> np.ndarray:
    """A scene's disparity as ETH3D's and Middlebury's PFM gt: inf where it is
    unknown, which is where the match lies outside the right view (x < d)
    and at a random `share` of the pixels (drawn from `scene_seed + 777`)."""
    rng = np.random.default_rng(scene_seed + 777)
    xs = np.arange(disp.shape[1])[None, :]
    unknown = (rng.random(disp.shape) < share) | (xs < disp)
    return np.where(unknown, np.inf, disp).astype(np.float32)


def _write_procedural_scene(job) -> None:
    """job: (root, a split of the SceneFlow layout or a KITTI layout, index,
    (h, w), scene seed), or (root, a layout of BENCHMARK_LAYOUTS, index,
    (h, w), scene seed, (dmin, dmax))."""
    root, split, index, (h, w), scene_seed, *drange = job
    if split in BENCHMARK_LAYOUTS:
        left, right, disp = procedural_scene(scene_seed, h, w, *drange[0])
        scene = Path(root) / f"scene{index:04d}"
        os.makedirs(scene, exist_ok=True)
        write_png(scene / "im0.png", left)
        write_png(scene / "im1.png", right)
        write_pfm(scene / "disp0GT.pfm", unknown_as_inf(disp, scene_seed, BENCHMARK_LAYOUTS[split][1]))
        return
    left, right, disp = procedural_scene(scene_seed, h, w)
    if split in KITTI_LAYOUTS:
        dirs = [Path(root) / d for d in KITTI_LAYOUTS[split]]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        name = f"{index:06d}_10.png"
        for d, img in zip(dirs, (left, right, kitti_sparse_gt(disp, scene_seed))):
            write_png(d / name, img)
        return
    seq, frame = f"{index // 100:04d}", f"{index % 100:04d}"
    img_dir = Path(root) / "frames_finalpass" / split / "A" / seq
    disp_dir = Path(root) / "frames_disparity" / split / "A" / seq / "left"
    for d in (img_dir / "left", img_dir / "right", disp_dir):
        os.makedirs(d, exist_ok=True)
    write_png(img_dir / "left" / f"{frame}.png", left)
    write_png(img_dir / "right" / f"{frame}.png", right)
    write_pfm(disp_dir / f"{frame}.pfm", disp)


def _write_scenes(jobs, workers: Optional[int]) -> None:
    """Each job over `workers` spawned processes (default: the host's cores,
    at most 16; 1 writes in this process)."""
    workers = min(os.cpu_count() or 1, 16) if workers is None else workers
    if workers <= 1 or len(jobs) <= 1:
        for job in jobs:
            _write_procedural_scene(job)
        return
    # chunks of up to 4 jobs, at least 4 chunks a worker where there are
    # enough jobs: a few large scenes go one to a process
    chunk = min(4, max(1, len(jobs) // (4 * workers)))
    with multiprocessing.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
        for _ in pool.imap_unordered(_write_procedural_scene, jobs, chunksize=chunk):
            pass


def write_procedural_sceneflow_tree(
    root: Union[str, Path], n_train: int, n_test: int, hw: Tuple[int, int] = (320, 640), seed: int = 0,
    workers: Optional[int] = None,
) -> Path:
    """Write `n_train` TRAIN and `n_test` TEST procedural scenes of size `hw`
    under `root` in the SceneFlow layout, over `workers` spawned processes
    (default: the host's cores, at most 16; 1 writes in this process);
    returns `root`."""
    root = Path(root)
    _write_scenes([(str(root), split, i, tuple(hw), procedural_seed(seed, split, i))
                   for split, n in (("TRAIN", n_train), ("TEST", n_test)) for i in range(n)], workers)
    return root


def write_procedural_kitti_tree(
    root: Union[str, Path], layout: str, n: int, hw: Tuple[int, int] = (376, 1248), seed: int = 0,
    workers: Optional[int] = None,
) -> Path:
    """Write `n` procedural scenes of size `hw` under `root` in the KITTI
    `layout` ("kitti2012" or "kitti2015"), scene i from the seed
    seed * 1_000_000 + i, over `workers` spawned processes (as
    `write_procedural_sceneflow_tree`); returns `root`."""
    if layout not in KITTI_LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(KITTI_LAYOUTS)}, got {layout!r}")
    root = Path(root)
    _write_scenes([(str(root), layout, i, tuple(hw), procedural_seed(seed, "TRAIN", i)) for i in range(n)], workers)
    return root


def _write_procedural_benchmark_tree(root, layout, n, hw, seed, workers, disp_range) -> Path:
    root = Path(root)
    drange = tuple(disp_range or BENCHMARK_LAYOUTS[layout][0])
    _write_scenes([(str(root), layout, i, tuple(hw), procedural_seed(seed, "TRAIN", i), drange) for i in range(n)],
                  workers)
    return root


def write_procedural_eth3d_tree(
    root: Union[str, Path], n: int, hw: Tuple[int, int] = (489, 941), seed: int = 0,
    workers: Optional[int] = None, disp_range: Optional[Tuple[float, float]] = None,
) -> Path:
    """Write `n` procedural scenes of size `hw` (an ETH3D two-view frame's)
    under `root` in the ETH3D layout, `<root>/scene<index:04d>/{im0.png,
    im1.png, disp0GT.pfm}`, scene i from the seed seed * 1_000_000 + i, its
    disparities in `disp_range` (default BENCHMARK_LAYOUTS["eth3d"]'s), its
    gt inf where unknown (`unknown_as_inf`), over `workers` spawned
    processes (as `write_procedural_sceneflow_tree`); returns `root`."""
    return _write_procedural_benchmark_tree(root, "eth3d", n, hw, seed, workers, disp_range)


def write_procedural_middlebury_tree(
    root: Union[str, Path], n: int, hw: Tuple[int, int] = (1988, 2880), seed: int = 0,
    workers: Optional[int] = None, disp_range: Optional[Tuple[float, float]] = None,
) -> Path:
    """Write `n` procedural scenes of size `hw` (a full-resolution MiddEval3
    frame's) under `root` in the Middlebury layout, the ETH3D one's
    (`<root>/scene<index:04d>/{im0.png, im1.png, disp0GT.pfm}`), with
    full-resolution disparities in `disp_range` (default
    BENCHMARK_LAYOUTS["middlebury"]'s: halved, the upper part lies past the
    preset's maxdisp 240), as `write_procedural_eth3d_tree`; returns
    `root`."""
    return _write_procedural_benchmark_tree(root, "middlebury", n, hw, seed, workers, disp_range)
