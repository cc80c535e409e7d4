"""The port's ETH3D and Middlebury data paths against the JAX package's, on
the CPU, on procedural trees in the benchmarks' layout.

- `data/synthetic.py::write_procedural_eth3d_tree` and
  `write_procedural_middlebury_tree`: `<root>/scene<i:04d>/{im0.png,
  im1.png, disp0GT.pfm}`, each file decoding (the port's readers and the
  JAX package's, PIL for the PNGs) to `procedural_scene` at the tree's
  seed, the gt inf where `unknown_as_inf` puts it; the tree written over
  two spawned workers equal to the one written in one process, file for
  file.
- `read_disparity` of the PFMs: inf -> 0, equal to the JAX package's.
- `build_dataset` of the `eth3d` and `middlebury` presets (their RunConfigs
  equal to the JAX package's): the same samples in the same order; the
  training transform (Middlebury: `half_res` first, then photometric
  jitter, the random crop cut to the test size, the right image's
  occlusion patch), sample for sample against the JAX `StereoDataset` from
  the same seeds, and the Loader's batches of both; the test samples and
  `eval_transform` (ETH3D's 768x1024 canvas, Middlebury's replicate pad to
  /64 with the gt zero-padded around it). Middlebury on an even and an odd
  scene size (the halving drops an odd row and column). Tolerances: the gt
  and the pads exactly; the images 1e-5 after the ImageNet normalisation
  (tests/test_torch_kitti_data.py's).
- The halving's border: the inf pixels read as 0 and the halving averages
  them into their 2x2 block, as the JAX package does; such blocks keep a
  positive gt below the block's own disparity, which the mask at maxdisp
  keeps; at the Middlebury range's upper part the halved gt passes the
  preset's maxdisp scaled to the test (48) and the mask drops it.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from dcanet_tpu import cli as jcli
from dcanet_tpu import config as jconfig
from dcanet_tpu.data import datasets as jds
from dcanet_tpu.data import eval_protocol as jep
from dcanet_tpu.data import io as jio
from dcanet_tpu.data import loader as jloader
from dcanet_tpu_torch import cli as tcli
from dcanet_tpu_torch import config as tconfig
from dcanet_tpu_torch.data import datasets as tds
from dcanet_tpu_torch.data import eval_protocol as tep
from dcanet_tpu_torch.data import io as tio
from dcanet_tpu_torch.data import loader as tloader
from dcanet_tpu_torch.data import synthetic

torch.set_num_threads(2)

N, SEED = 3, 9
# full-resolution sizes: Middlebury even and odd (halved 226x265 and 227x266),
# ETH3D odd; crops cut to the test size (h > 2 * 100 keeps every occlusion
# patch possible)
MIDDLEBURY_HW = {"even": (452, 530), "odd": (455, 533)}
ETH3D_HW, CROP = (241, 301), (208, 224)
# Middlebury's full-resolution range scaled to the tests' maxdisp 48 (the
# preset's 240): halved, its upper part lies past 48
MIDDLEBURY_RANGE, MAXDISP = (8.0, 136.0), 48
IMAGE_ATOL = 1e-5
SEEDS = range(5)  # the training transform's epoch seeds
TREES = ("middlebury even", "middlebury odd", "eth3d")


def _write(kind, root, workers):
    if kind == "eth3d":
        return synthetic.write_procedural_eth3d_tree(root, N, ETH3D_HW, seed=SEED, workers=workers)
    return synthetic.write_procedural_middlebury_tree(root, N, MIDDLEBURY_HW[kind.split()[1]], seed=SEED,
                                                      workers=workers, disp_range=MIDDLEBURY_RANGE)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """kind -> (the tree written in one process, the tree over 2 workers)."""
    base = tmp_path_factory.mktemp("benchmarks")
    return {kind: (_write(kind, base / "one" / kind.replace(" ", "_"), 1),
                   _write(kind, base / "pool" / kind.replace(" ", "_"), 2)) for kind in TREES}


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("kind", TREES)
def test_tree_layout_and_scenes(trees, kind):
    root = trees[kind][0]
    layout = kind.split()[0]
    hw = ETH3D_HW if layout == "eth3d" else MIDDLEBURY_HW[kind.split()[1]]
    drange = synthetic.BENCHMARK_LAYOUTS[layout][0] if layout == "eth3d" else MIDDLEBURY_RANGE
    share = synthetic.BENCHMARK_LAYOUTS[layout][1]
    assert _files(root) == sorted(Path(f"scene{i:04d}") / f for i in range(N)
                                  for f in ("im0.png", "im1.png", "disp0GT.pfm"))
    for i in range(N):
        scene_seed = synthetic.procedural_seed(SEED, "TRAIN", i)
        left, right, disp = synthetic.procedural_scene(scene_seed, *hw, *drange)
        scene = root / f"scene{i:04d}"
        for name, want in (("im0.png", left), ("im1.png", right)):
            np.testing.assert_array_equal(tio.read_png(scene / name), want)
            np.testing.assert_array_equal(np.asarray(Image.open(scene / name)), want)
            np.testing.assert_array_equal(tio.read_image(scene / name), jio.read_image(str(scene / name)))
        raw, _ = tio.read_pfm(scene / "disp0GT.pfm")
        np.testing.assert_array_equal(raw, synthetic.unknown_as_inf(disp, scene_seed, share))
        np.testing.assert_array_equal(raw, jio.read_pfm(str(scene / "disp0GT.pfm"))[0])
        unknown = np.isinf(raw)
        xs = np.arange(hw[1])[None, :]
        assert unknown[xs < disp].all() and share < unknown.mean() < share + 0.3
        np.testing.assert_array_equal(raw[~unknown], disp[~unknown])
        # inf -> 0, as the JAX package reads it
        gt = tio.read_disparity(scene / "disp0GT.pfm")
        np.testing.assert_array_equal(gt, jio.read_disparity(str(scene / "disp0GT.pfm")))
        np.testing.assert_array_equal(gt, np.where(unknown, 0.0, disp).astype(np.float32))


@pytest.mark.parametrize("kind", TREES)
def test_tree_over_workers_equals_one_process(trees, kind):
    one, pool = trees[kind]
    files = _files(one)
    assert len(files) == 3 * N and files == _files(pool)
    for f in files:
        assert (one / f).read_bytes() == (pool / f).read_bytes(), f


def test_default_sizes_and_ranges():
    """The writers' defaults: an ETH3D two-view frame and a full-resolution
    MiddEval3 frame, and the Middlebury range's upper part past the
    preset's maxdisp once halved."""
    import inspect

    eth3d = inspect.signature(synthetic.write_procedural_eth3d_tree).parameters["hw"].default
    middlebury = inspect.signature(synthetic.write_procedural_middlebury_tree).parameters["hw"].default
    assert eth3d == (489, 941) and middlebury == (1988, 2880)
    (_, dmax), _ = synthetic.BENCHMARK_LAYOUTS["middlebury"]
    assert dmax / 2 > tconfig.preset("middlebury").maxdisp == 240


@pytest.mark.parametrize("name", ["eth3d", "middlebury"])
def test_presets_match_jax(name):
    ours, theirs = tconfig.preset(name), jconfig.preset(name)
    shared = {f.name for f in dataclasses.fields(ours)} & {f.name for f in dataclasses.fields(theirs)}
    assert {"dataset", "loss_preset", "maxdisp", "half_res", "lr_spec", "epochs", "batch_size"} <= shared
    assert {k: getattr(ours, k) for k in shared} == {k: getattr(theirs, k) for k in shared}
    assert tcli._protocol_preset(ours) == jcli._protocol_preset(theirs) == name


def _datasets(trees, kind, training):
    """The port's and the JAX package's StereoDataset of the tree's preset."""
    name = kind.split()[0]
    root = str(trees[kind][0])
    cfg = tconfig.preset(name, data_root=root)
    ours = tcli.build_dataset(cfg, training)
    theirs = jcli._build_dataset(SimpleNamespace(dataset=name, data_root=root, data_root2=None,
                                                 half_res=cfg.half_res), training)
    if training:
        ours.cfg, theirs.cfg = dict(ours.cfg, crop=CROP), dict(theirs.cfg, crop=CROP)
    return ours, theirs


@pytest.mark.parametrize("kind", TREES)
def test_samples_match_jax(trees, kind):
    ours, theirs = _datasets(trees, kind, True)
    name = kind.split()[0]
    assert ours.preset == theirs.preset == name and ours.half_res == theirs.half_res == (name == "middlebury")
    assert ours.cfg == dict(theirs.cfg)
    assert [tuple(vars(s).values()) for s in ours.samples] == [tuple(vars(s).values()) for s in theirs.samples]
    assert [Path(s.left).parent.name for s in ours.samples] == [f"scene{i:04d}" for i in range(N)]


def _close_sample(got, want):
    assert got["left"].shape == (3, *want["left"].shape[:2]) and got["disparity"].shape == want["disparity"].shape
    for k in ("left", "right"):
        np.testing.assert_allclose(got[k], want[k].transpose(2, 0, 1), rtol=0, atol=IMAGE_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["disparity"], want["disparity"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", TREES)
def test_training_transform_matches_jax(trees, kind, seed):
    """Every sample through the training transform (Middlebury halved first):
    photometric jitter, the crop, the occlusion patch, the gt."""
    ours, theirs = _datasets(trees, kind, True)
    ours.reseed(seed)
    theirs.reseed(seed)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got["left"].shape == (3, *CROP)
        _close_sample(got, want)


@pytest.mark.parametrize("kind", TREES)
def test_training_transform_occludes_and_jitters(trees, kind):
    """Over the seeds of the test above, the occlusion patch is drawn at
    least once and the jitter always: the cases above exercise both. The
    patch is found against the same transform without it (its draw comes
    last, so the jitter and the crop stay), the jitter against the images
    with neither."""
    ours, _ = _datasets(trees, kind, True)
    open_right = tds.StereoDataset(ours.samples, True, ours.preset, half_res=ours.half_res)
    open_right.cfg = dict(ours.cfg, occlusion=False)
    plain = tds.StereoDataset(ours.samples, True, ours.preset, half_res=ours.half_res)
    plain.cfg = dict(ours.cfg, photometric=False, occlusion=False)
    occluded = jittered = 0
    for seed in SEEDS:
        for ds in (ours, open_right, plain):
            ds.reseed(seed)
        for i in range(len(ours)):
            got = ours[i]
            changed = (got["right"] != open_right[i]["right"]).any(axis=0)
            np.testing.assert_array_equal(got["left"], open_right[i]["left"])
            occluded += bool(changed.sum() >= 70 * 50)  # a patch is at least 70 x 50
            assert changed.sum() == 0 or changed.sum() >= 70 * 50
            jittered += not np.allclose(got["left"], plain[i]["left"])
    assert occluded >= 1 and jittered == len(SEEDS) * len(ours), (occluded, jittered)


@pytest.mark.parametrize("kind", TREES)
def test_eval_transform_matches_jax(trees, kind):
    """The test split as `cli eval` reads it (Middlebury halved), then the
    protocol: ETH3D's 768x1024 canvas, Middlebury's replicate pad to /64
    split top/bottom and left/right with the gt zero-padded the same way."""
    ours, theirs = _datasets(trees, kind, False)
    name = kind.split()[0]
    assert len(ours) == len(theirs) == N
    for i in range(N):
        got, want = ours[i], theirs[i]
        _close_sample(got, want)
        left, right, gt, pads = tep.eval_transform(got, name)
        jl, jr, jgt, jpads = jep.eval_transform(want, name)
        assert tuple(pads) == tuple(jpads) and left.shape == (3, *jl.shape[:2])
        np.testing.assert_allclose(left, jl.transpose(2, 0, 1), rtol=0, atol=IMAGE_ATOL)
        np.testing.assert_allclose(right, jr.transpose(2, 0, 1), rtol=0, atol=IMAGE_ATOL)
        np.testing.assert_array_equal(gt, jgt)
        h, w = got["disparity"].shape
        if name == "eth3d":
            assert left.shape[1:] == gt.shape == (768, 1024) and pads == (0, 0)
            np.testing.assert_array_equal(gt[768 - h:, :w], got["disparity"])
        else:
            hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
            top, lft = (hp - h) // 2, (wp - w) // 2
            assert left.shape[1:] == gt.shape == (hp, wp) and pads == (0, 0)
            np.testing.assert_array_equal(gt[top:top + h, lft:lft + w], got["disparity"])
            outside = gt.copy()
            outside[top:top + h, lft:lft + w] = 0
            assert not outside.any()  # zeros around it
            # the replicate pad: the rows above the image repeat its first row
            np.testing.assert_array_equal(left[:, :top, lft:lft + w], np.repeat(got["left"][:, :1], top, axis=1))


@pytest.mark.parametrize("size", ["even", "odd"])
def test_half_res_gt_and_the_inf_border(trees, size):
    """Middlebury's halved gt, pixel for pixel: the inf pixels read as 0,
    each 2x2 block's mean x 0.5 (an odd last row and column dropped), as
    the JAX package computes it; blocks that mix known and unknown pixels
    keep a positive gt below the block's disparity, and the upper part of
    the range lies past maxdisp, where the mask drops it."""
    ours, theirs = _datasets(trees, f"middlebury {size}", False)
    h, w = MIDDLEBURY_HW[size]
    mixed = dropped = 0
    for i in range(N):
        got, want = ours[i]["disparity"], theirs[i]["disparity"]
        np.testing.assert_array_equal(got, want)
        raw, _ = tio.read_pfm(Path(ours.samples[i].disparity))
        full = np.where(np.isinf(raw), 0.0, raw).astype(np.float32)[: h // 2 * 2, : w // 2 * 2]
        blocks = full.reshape(h // 2, 2, w // 2, 2)
        assert got.shape == (h // 2, w // 2)
        np.testing.assert_array_equal(got, (blocks.mean(axis=(1, 3)) * 0.5).astype(np.float32))
        unknown = np.isinf(raw)[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2)
        part = unknown.any(axis=(1, 3)) & ~unknown.all(axis=(1, 3))
        assert (got[part] > 0).all() and (got[part] < 0.5 * blocks.max(axis=(1, 3))[part]).all()
        mixed += int(part.sum())
        dropped += int((got >= MAXDISP).sum())
        mask = (got > 0) & (got < MAXDISP)
        assert mask[part].any() and not mask[got >= MAXDISP].any()
    assert mixed > 0 and dropped > 0, (mixed, dropped)


def test_loader_batches_match_jax(trees):
    ours, theirs = _datasets(trees, "middlebury odd", True)
    for epoch in (0, 1):
        tl, jl = tloader.Loader(ours, 2, seed=3, num_workers=2), jloader.Loader(theirs, 2, seed=3, num_workers=2)
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            assert g["left"].shape == (2, 3, *CROP)
            for k in ("left", "right"):
                np.testing.assert_allclose(g[k], w[k].transpose(0, 3, 1, 2), rtol=0, atol=IMAGE_ATOL)
            np.testing.assert_array_equal(g["disparity"], w["disparity"])


def test_scan_middlebury_additional_matches_jax(trees):
    """`scan_middlebury(additional=True)` reads disp0.pfm; a scene without
    its gt file gets none, in both packages."""
    root = trees["middlebury odd"][0]
    for additional in (False, True):
        got = tds.scan_middlebury(str(root), additional)
        want = jds.scan_middlebury(str(root), additional)
        assert [tuple(vars(s).values()) for s in got] == [tuple(vars(s).values()) for s in want]
        assert all((s.disparity is None) == additional for s in got)
