"""The port's KITTI data path against the JAX package's, on the CPU, on the
procedural KITTI trees of the fine-tune leg.

- `data/synthetic.py::write_procedural_kitti_tree` against
  tools/gen_synthetic_sceneflow.py::_write_sample (PIL, one process) for
  the kitti2012 and kitti2015 layouts: the same files, whose left, right
  and uint16 gt arrays are equal read by PIL and by the port's `read_png`,
  either file by either reader (pixel for pixel), and equal to the tool's
  `make_scene` with its sparse gt rule; the tree written over two spawned
  workers equals the one written in one process, file for file.
- `kitti_mix` built by both `build_dataset`s on those trees: the same
  samples in the same order, KITTI 2012 first.
- The `kitti` training transform (photometric jitter, random crop cut to
  the test size, the right image's occlusion patch, the sparse gt) and the
  eval transform (`eval_protocol.eval_transform(..., "kitti")`), sample for
  sample against the JAX `StereoDataset` from the same seeds, and the
  Loader's batches of both. Tolerances: the gt and the pads exactly; the
  images 1e-5 after the ImageNet normalisation (the photometric jitter's
  float32 maths in another order: 1e-4 on the 0-255 scale,
  tests/test_torch_data.py, over 255 * 0.225).
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from dcanet_tpu import cli as jcli
from dcanet_tpu.data import datasets as jds
from dcanet_tpu.data import eval_protocol as jep
from dcanet_tpu.data import io as jio
from dcanet_tpu.data import loader as jloader
from dcanet_tpu_torch import cli as tcli
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.data import datasets as tds
from dcanet_tpu_torch.data import eval_protocol as tep
from dcanet_tpu_torch.data import io as tio
from dcanet_tpu_torch.data import loader as tloader
from dcanet_tpu_torch.data import synthetic

torch.set_num_threads(2)

TOOL = Path(__file__).resolve().parents[1] / "tools" / "gen_synthetic_sceneflow.py"
HW, N, SEED = (240, 320), 3, 7  # a tree per layout, scenes of the tool's --seed SEED
CROP = (224, 256)  # the kitti crop cut to the test size; h > 2 * 100 keeps every occlusion patch possible
IMAGE_ATOL = 1e-5


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("gen_synthetic_sceneflow", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def trees(tool, tmp_path_factory):
    """layout -> (the port's tree, the port's tree over 2 workers, the tool's tree)."""
    base = tmp_path_factory.mktemp("kitti")
    out = {}
    for layout in ("kitti2012", "kitti2015"):
        port = synthetic.write_procedural_kitti_tree(base / "port" / layout, layout, N, HW, seed=SEED, workers=1)
        pool = synthetic.write_procedural_kitti_tree(base / "pool" / layout, layout, N, HW, seed=SEED, workers=2)
        jax_root = base / "tool" / layout
        for i in range(N):
            tool._write_sample((str(jax_root), "TRAIN", i, *HW, SEED * 1_000_000 + i, layout))
        out[layout] = (port, pool, jax_root)
    return out


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("layout", ["kitti2012", "kitti2015"])
def test_tree_equals_the_tools_pixel_for_pixel(tool, trees, layout):
    port, _, jax_root = trees[layout]
    dirs = synthetic.KITTI_LAYOUTS[layout]
    names = [f"{i:06d}_10.png" for i in range(N)]
    assert _files(port) == _files(jax_root) == sorted(Path(d) / n for d in dirs for n in names)
    for i, name in enumerate(names):
        left, right, disp = tool.make_scene(SEED * 1_000_000 + i, *HW)
        for d, want in zip(dirs, (left, right, synthetic.kitti_sparse_gt(disp, SEED * 1_000_000 + i))):
            ours, theirs = port / d / name, jax_root / d / name
            arrays = [tio.read_png(ours), tio.read_png(theirs), np.asarray(Image.open(ours)),
                      np.asarray(Image.open(theirs))]
            for a in arrays:
                assert a.dtype == want.dtype and a.shape == want.shape, (d, a.dtype, a.shape)
                np.testing.assert_array_equal(a, want, err_msg=f"{d}/{name}")
        gt = tio.read_png(port / dirs[2] / name)
        assert gt.dtype == np.uint16 and 0.5 < (gt > 0).mean() < 0.8  # ~20 % dropped, and the left band
        xs = np.arange(HW[1])[None, :]
        assert not (gt[xs < disp] > 0).any()
        np.testing.assert_array_equal(gt[gt > 0], np.clip(disp * 256.0, 1, 65535).astype(np.uint16)[gt > 0])
        np.testing.assert_array_equal(tio.read_disparity(port / dirs[2] / name),
                                      jio.read_disparity(str(jax_root / dirs[2] / name)))
        np.testing.assert_array_equal(tio.read_image(port / dirs[0] / name), jio.read_image(str(jax_root / dirs[0] / name)))


@pytest.mark.parametrize("layout", ["kitti2012", "kitti2015"])
def test_tree_over_workers_equals_one_process(trees, layout):
    port, pool, _ = trees[layout]
    files = _files(port)
    assert len(files) == 3 * N and files == _files(pool)
    for f in files:
        assert (port / f).read_bytes() == (pool / f).read_bytes(), f


def test_layout_is_checked(tmp_path):
    with pytest.raises(ValueError, match="layout"):
        synthetic.write_procedural_kitti_tree(tmp_path, "sceneflow", 1, (32, 64), workers=1)


def _datasets(trees, training, dataset="kitti_mix"):
    """The port's and the JAX package's StereoDataset of the kitti preset."""
    k12, k15 = trees["kitti2012"][0], trees["kitti2015"][0]
    root = k15 if dataset == "kitti2015" else k12
    cfg = preset("kitti", dataset=dataset, data_root=str(root), data_root2=str(k15))
    jcfg = SimpleNamespace(dataset=dataset, data_root=str(root), data_root2=str(k15), half_res=False)
    ours, theirs = tcli.build_dataset(cfg, training), jcli._build_dataset(jcfg, training)
    if training:
        ours.cfg, theirs.cfg = dict(ours.cfg, crop=CROP), dict(theirs.cfg, crop=CROP)
    return ours, theirs


def test_kitti_mix_samples_match_jax(trees):
    ours, theirs = _datasets(trees, True)
    assert ours.preset == theirs.preset == "kitti" and ours.cfg == dict(theirs.cfg)
    assert [tuple(vars(s).values()) for s in ours.samples] == [tuple(vars(s).values()) for s in theirs.samples]
    assert len(ours) == 2 * N
    assert [Path(s.left).parent.name for s in ours.samples] == ["colored_0"] * N + ["image_2"] * N


def _close_sample(got, want):
    assert got["left"].shape == (3, *want["left"].shape[:2]) and got["disparity"].shape == want["disparity"].shape
    for k in ("left", "right"):
        np.testing.assert_allclose(got[k], want[k].transpose(2, 0, 1), rtol=0, atol=IMAGE_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["disparity"], want["disparity"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kitti_training_transform_matches_jax(trees, seed):
    """Every sample of kitti_mix through the training transform: photometric
    jitter, the crop, the occlusion patch, the sparse gt (0 where none)."""
    ours, theirs = _datasets(trees, True)
    ours.reseed(seed)
    theirs.reseed(seed)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got["left"].shape == (3, *CROP)
        _close_sample(got, want)
        assert (got["disparity"] == 0).any() and (got["disparity"] > 0).mean() > 0.4


def test_kitti_training_transform_occludes_and_jitters(trees):
    """Over the seeds of the test above, the occlusion patch (mean-filled
    rows of the right image) is drawn at least once and the jitter always:
    the cases above exercise both."""
    ours, _ = _datasets(trees, True)
    plain = tds.StereoDataset(ours.samples, True, "kitti")
    plain.cfg = dict(ours.cfg, photometric=False, occlusion=False)
    occluded = jittered = 0
    for seed in range(4):
        ours.reseed(seed)
        for i in range(len(ours)):
            right = ours[i]["right"]
            flat = (right == right[:, :1, :1]).all(axis=0)
            occluded += bool(flat.sum() >= 70 * 50)  # a patch is at least 70 x 50
            jittered += not np.allclose(ours[i]["left"], plain[i]["left"])
    assert occluded >= 1 and jittered == 4 * len(ours), (occluded, jittered)


@pytest.mark.parametrize("dataset", ["kitti2015", "kitti_mix"])
def test_kitti_eval_transform_matches_jax(trees, dataset):
    """The test split as `cli eval` reads it: full images, then the KITTI
    protocol's bottom-right crop and pad to /16 (here 240x320: no crop, no pad)."""
    ours, theirs = _datasets(trees, False, dataset)
    assert len(ours) == len(theirs) == (N if dataset == "kitti2015" else 2 * N)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        _close_sample(got, want)
        left, right, gt, pads = tep.eval_transform(got, "kitti")
        jl, jr, jgt, jpads = jep.eval_transform(want, "kitti")
        assert tuple(pads) == tuple(jpads) and left.shape == (3, *jl.shape[:2])
        np.testing.assert_allclose(left, jl.transpose(2, 0, 1), rtol=0, atol=IMAGE_ATOL)
        np.testing.assert_allclose(right, jr.transpose(2, 0, 1), rtol=0, atol=IMAGE_ATOL)
        np.testing.assert_array_equal(gt, jgt)


def test_kitti_loader_batches_match_jax(trees):
    ours, theirs = _datasets(trees, True)
    for epoch in (0, 1):
        tl, jl = tloader.Loader(ours, 4, seed=3, num_workers=2), jloader.Loader(theirs, 4, seed=3, num_workers=2)
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            assert g["left"].shape == (4, 3, *CROP)
            for k in ("left", "right"):
                np.testing.assert_allclose(g[k], w[k].transpose(0, 3, 1, 2), rtol=0, atol=IMAGE_ATOL)
            np.testing.assert_array_equal(g["disparity"], w["disparity"])
