"""The port's procedural scene generator (dcanet_tpu_torch/data/synthetic.py)
against the JAX package's (tools/gen_synthetic_sceneflow.py), on the CPU.

- `procedural_scene` equals the tool's `make_scene` bit for bit: both
  images and the disparity, for several seeds, sizes and disparity ranges.
- `write_procedural_sceneflow_tree` writes the tool's layout and seeds: the
  port's `scan_sceneflow` finds its TRAIN and TEST pairs, and each decodes
  (`read_image`, `read_disparity`) to the arrays of `make_scene` at the
  tool's seed for that split and index; the tree written over spawned
  worker processes equals the one written in one process, file for file.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from dcanet_tpu_torch.data import synthetic
from dcanet_tpu_torch.data.datasets import scan_sceneflow
from dcanet_tpu_torch.data.io import read_disparity, read_image

torch.set_num_threads(2)

TOOL = Path(__file__).resolve().parents[1] / "tools" / "gen_synthetic_sceneflow.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("gen_synthetic_sceneflow", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed, hw, drange", [
    (0, (48, 96), (4.0, 88.0)),
    (1, (48, 96), (4.0, 88.0)),
    (7, (64, 128), (4.0, 88.0)),
    (500_003, (40, 72), (4.0, 88.0)),
    (12_345, (32, 200), (2.0, 30.0)),
    (3, (320, 640), (4.0, 88.0)),
])
def test_procedural_scene_equals_the_tool(tool, seed, hw, drange):
    got = synthetic.procedural_scene(seed, *hw, *drange)
    want = tool.make_scene(seed, *hw, *drange)
    for g, w, dtype in zip(got, want, (np.uint8, np.uint8, np.float32)):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[2].min() >= drange[0] and got[2].max() < drange[1]


def test_procedural_seeds_are_the_tools():
    assert synthetic.procedural_seed(0, "TRAIN", 5) == 5
    assert synthetic.procedural_seed(2, "TRAIN", 7) == 2_000_007
    assert synthetic.procedural_seed(2, "TEST", 7) == 2_500_007


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same tree (3 TRAIN, 2 TEST, 48x96, seed 4) written in one process
    and over two spawned workers."""
    base = tmp_path_factory.mktemp("procedural")
    one = synthetic.write_procedural_sceneflow_tree(base / "one", 3, 2, (48, 96), seed=4, workers=1)
    pool = synthetic.write_procedural_sceneflow_tree(base / "pool", 3, 2, (48, 96), seed=4, workers=2)
    return one, pool


def test_tree_scans_and_decodes_to_the_tools_scenes(tool, trees):
    root = trees[0]
    train, test = scan_sceneflow(str(root))
    assert (len(train), len(test)) == (3, 2)
    for split, samples, offset in (("TRAIN", train, 0), ("TEST", test, 500_000)):
        for i, s in enumerate(samples):
            assert Path(s.left) == root / "frames_finalpass" / split / "A" / "0000" / "left" / f"{i:04d}.png"
            left, right, disp = tool.make_scene(4 * 1_000_000 + offset + i, 48, 96)
            np.testing.assert_array_equal(read_image(s.left), left.astype(np.float32))
            np.testing.assert_array_equal(read_image(s.right), right.astype(np.float32))
            np.testing.assert_array_equal(read_disparity(s.disparity), disp)


def test_tree_over_workers_equals_one_process(trees):
    one, pool = trees
    files = sorted(p.relative_to(one) for p in one.rglob("*") if p.is_file())
    assert len(files) == 3 * 5 and files == sorted(p.relative_to(pool) for p in pool.rglob("*") if p.is_file())
    for f in files:
        assert (one / f).read_bytes() == (pool / f).read_bytes(), f
