"""The port's training data layer against dcanet_tpu.data: PFM IO,
`read_disparity`, the augmentations, the dataset scanners, StereoDataset
samples (the port's are channel-first) and Loader batches, on the same
files and seeds; and the synthetic SceneFlow tree the smoke run trains on.
Exact equality except where float32 maths runs in another order (1e-6).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from dcanet_tpu.data import augment as jaug
from dcanet_tpu.data import datasets as jds
from dcanet_tpu.data import io as jio
from dcanet_tpu.data import loader as jloader
from dcanet_tpu_torch.data import augment as taug
from dcanet_tpu_torch.data import datasets as tds
from dcanet_tpu_torch.data import io as tio
from dcanet_tpu_torch.data import loader as tloader
from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(7, 9), (5, 6, 3)])
def test_pfm_roundtrip_against_jax(tmp_path, rng, shape):
    data = rng.standard_normal(shape).astype(np.float32)
    ours, theirs = tmp_path / "ours.pfm", tmp_path / "jax.pfm"
    tio.write_pfm(ours, data, scale=2.0)
    jio.write_pfm(theirs, data, scale=2.0)
    assert ours.read_bytes() == theirs.read_bytes()
    got, scale = tio.read_pfm(theirs)
    want, want_scale = jio.read_pfm(theirs)
    assert scale == want_scale == 2.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)


def test_read_disparity_against_jax(tmp_path, rng):
    pfm = rng.uniform(0, 100, (6, 8)).astype(np.float32)
    pfm[0, 0] = np.inf  # Middlebury's unknown disparity
    tio.write_pfm(tmp_path / "d.pfm", pfm)
    kitti = (rng.uniform(0, 200, (6, 8)) * 256).astype(np.uint16)
    Image.fromarray(kitti).save(tmp_path / "d.png")
    for name in ("d.pfm", "d.png"):
        got = tio.read_disparity(tmp_path / name)
        want = jio.read_disparity(str(tmp_path / name))
        assert got.dtype == np.float32 and got.shape == (6, 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert tio.read_disparity(tmp_path / "d.pfm")[0, 0] == 0.0


def test_augmentations_match_jax(rng):
    left = rng.uniform(0, 255, (120, 240, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (120, 240, 3)).astype(np.float32)
    disp = rng.uniform(0, 50, (120, 240)).astype(np.float32)
    for seed in range(4):
        got = taug.photometric_pair(left, right, np.random.default_rng(seed))
        want = jaug.photometric_pair(left, right, np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(taug.occlusion_patch(right, np.random.default_rng(seed), prob=1.0),
                                      jaug.occlusion_patch(right, np.random.default_rng(seed), prob=1.0))
        for g, w in zip(taug.random_crop(left, right, disp, (64, 128), np.random.default_rng(seed)),
                        jaug.random_crop(left, right, disp, (64, 128), np.random.default_rng(seed))):
            np.testing.assert_array_equal(g, w)


def test_scan_sceneflow_and_dataset_match_jax(tmp_path):
    root = write_sceneflow_tree(tmp_path / "sf", 3, (40, 72), seed=1, max_disp=20)
    train_t, test_t = tds.scan_sceneflow(str(root))
    train_j, test_j = jds.scan_sceneflow(str(root))
    assert [tuple(vars(s).values()) for s in train_t] == [tuple(vars(s).values()) for s in train_j]
    assert len(train_t) == 3 and test_t == test_j == []
    monkey_crop = (32, 64)
    ours = tds.StereoDataset(train_t, True, "sceneflow", seed=4)
    theirs = jds.StereoDataset(train_j, True, "sceneflow", seed=4)
    ours.cfg = dict(ours.cfg, crop=monkey_crop)
    theirs.cfg = dict(theirs.cfg, crop=monkey_crop)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got["left"].shape == (3, 32, 64) and got["disparity"].shape == (32, 64)
        for k in ("left", "right"):
            np.testing.assert_allclose(got[k], want[k].transpose(2, 0, 1), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["disparity"], want["disparity"])


@pytest.mark.parametrize("scan", ["kitti2012", "kitti2015"])
def test_scan_kitti_matches_jax(tmp_path, scan):
    dirs = ("colored_0", "colored_1", "disp_occ") if scan == "kitti2012" else ("image_2", "image_3", "disp_occ_0")
    for d in dirs:
        (tmp_path / d).mkdir()
        for name in ("000001_10.png", "000000_10.png", "000000_11.png"):
            (tmp_path / d / name).write_bytes(b"")
    got = getattr(tds, f"scan_{scan}")(str(tmp_path))
    want = getattr(jds, f"scan_{scan}")(str(tmp_path))
    assert got == [tds.StereoSample(*vars(s).values()) for s in want] and len(got) == 2


def test_loader_batches_match_jax():
    class Samples:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.float32)}

    for epoch in (0, 3):
        ours, theirs = tloader.Loader(Samples(), 2, seed=5, num_workers=2), jloader.Loader(Samples(), 2, seed=5, num_workers=2)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(ours) == len(theirs) == 3 and len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"], w["x"])


def test_device_prefetch_on_cpu_wraps_arrays():
    batches = [{"x": np.arange(3, dtype=np.float32) + i} for i in range(3)]
    out = list(tloader.device_prefetch(iter(batches), "cpu"))
    assert [b["x"].tolist() for b in out] == [[0, 1, 2], [1, 2, 3], [2, 3, 4]]
    assert all(isinstance(b["x"], torch.Tensor) for b in out)


def test_synthetic_tree_is_consistent(tmp_path):
    """The right image is the left one shifted by the ground truth."""
    root = write_sceneflow_tree(tmp_path / "sf", 1, (24, 40), seed=2, min_disp=2, max_disp=9)
    seq = root / "frames_finalpass" / "TRAIN" / "A" / "0000"
    left = tio.read_image(seq / "left" / "0006.png")
    right = tio.read_image(seq / "right" / "0006.png")
    disp = tio.read_disparity(root / "frames_disparity" / "TRAIN" / "A" / "0000" / "left" / "0006.pfm")
    assert disp.min() == 2 and disp.max() == 9
    for y in range(24):
        d = int(disp[y, 0])
        np.testing.assert_array_equal(left[y, d:], right[y, : 40 - d])  # left[x] = right[x - d]
