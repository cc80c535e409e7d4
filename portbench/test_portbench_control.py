"""The correctness check's control and its faults must come out not correct.

The control is the reference computed one precision below the cell's
dtype and put in the program's place: float8 for the bf16 cells (run here
on the CPU at a small size), TF32 for the f32 cell (TF32 exists only on the
card: that test carries the `cuda` marker and skips here). Each fault test
drives the rest of a run (portbench/drivers) on the CPU at a tiny size with
the program broken underneath, and holds the numbers to the cell's own
limits: an answer altered where it is produced, a step that leaves its
state unchanged, half of the batch left out. The unbroken run at that size
is judged correct first, so that it is the fault that fails.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.drivers import serve, train  # noqa: E402
from portbench.lib import compare, inputs, manifest  # noqa: E402

TINY_SERVE = {"image_hw": [30, 62], "input_hw": [32, 64], "pool": 2, "disp_range": [1.0, 12.0]}
TINY_TRAIN = {"batch": 4, "crop_hw": [32, 64], "disp_range": [1.0, 12.0], "dtype": "float32"}
TINY_DCANET = {"model": "dcanet-cva1", "num_cva": 1, "maxdisp": 32,
               "layers": {"feature_extraction": "features"}}
SEED = 2**31 + 77
# the control's size: every layer of the cell, the crop and maxdisp cut
CONTROL_DCANET = {"model": "dcanet", "num_cva": 3, "maxdisp": 64}
CONTROL_TRAIN = {"batch": 4, "crop_hw": [64, 128], "disp_range": [1.0, 60.0], "dtype": "float32"}
CONTROL_SERVE = {"image_hw": [120, 250], "input_hw": [128, 256], "pool": 2}


def tiny_cell(tmp: Path, name: str, config: dict, traffic: dict) -> manifest.Cell:
    """The cell `name` with its config and traffic cut to a CPU test's size,
    held to the cell's own limits."""
    bench = manifest.load_benchmark()
    real = manifest.Cell(bench, name)
    (tmp / "portbench" / "configs").mkdir(parents=True)
    (tmp / "portbench" / "traffic").mkdir()
    (tmp / "portbench" / "limits").mkdir()
    entry = next(c for c in bench["configs"] if c["name"] == real.entry["config"])
    (tmp / entry["file"]).write_text(json.dumps(dict(real.config, **config)))
    (tmp / "portbench" / "traffic" / f"{real.entry['traffic']}.json").write_text(json.dumps(dict(real.traffic, **traffic)))
    (tmp / "portbench" / "limits" / f"{name}.json").write_text(json.dumps(real.limits))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return manifest.Cell(bench, name, tmp)


def _correct(cell, res) -> bool:
    return compare.judge(res["numbers"], cell.limits)[0]


# ---- the control ----

@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_fp8_control_fails_the_bf16_serve_cell(seed, tmp_path):
    cell = tiny_cell(tmp_path, "gwcnet-gc.serve-kitti.bf16", {}, CONTROL_SERVE)
    pairs = inputs.serve_pairs(seed, cell.traffic)
    state = serve.weights(cell.config, seed, pairs, "cpu")
    ref = serve.reference_disparities(cell.config, state, pairs, "cpu")
    ctrl = serve.reference_disparities(cell.config, state, pairs, "cpu", fp8=True)
    assert not compare.judge(compare.serve_numbers(list(enumerate(ctrl)), ref), cell.limits)[0]


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_fp8_control_fails_the_train_cell(seed, tmp_path):
    cell = tiny_cell(tmp_path, "dcanet.train-kitti.bf16", CONTROL_DCANET, CONTROL_TRAIN)
    ref = train.reference_steps(cell.config, cell.traffic, seed, "cpu")
    ctrl = train.reference_steps(cell.config, cell.traffic, seed, "cpu", fp8=True)
    assert not compare.judge(compare.train_numbers(ctrl, ref), cell.limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_tf32_control_fails_the_f32_serve_cell(seed):
    if not torch.cuda.is_available():
        pytest.skip("TF32 runs only on an NVIDIA GPU")
    cell = manifest.Cell(manifest.load_benchmark(), "dcanet.serve-kitti.f32")
    pairs = inputs.serve_pairs(seed, cell.traffic)
    state = serve.weights(cell.config, seed, pairs, "cuda")
    ref = serve.reference_disparities(cell.config, state, pairs, "cuda")
    ctrl = serve.reference_disparities(cell.config, state, pairs, "cuda", tf32=True)
    assert not compare.judge(compare.serve_numbers(list(enumerate(ctrl)), ref), cell.limits)[0]


# ---- the faults ----

def test_an_altered_answer_fails_the_serve_cell(tmp_path, monkeypatch):
    from dcanet_tpu_torch import cli

    cell = tiny_cell(tmp_path, "dcanet.serve-kitti.f32", TINY_DCANET, TINY_SERVE)
    assert _correct(cell, serve.run(cell, SEED, 0.5, False, "cpu"))
    forward, calls = cli._forward, []

    def altered(model, left, right, bf16):
        disp, seconds = forward(model, left, right, bf16)
        calls.append(1)
        return (disp + 2.0 if len(calls) == 5 else disp), seconds

    monkeypatch.setattr(cli, "_forward", altered)
    assert not _correct(cell, serve.run(cell, SEED, 0.5, False, "cpu"))


def _train_faults():
    from dcanet_tpu_torch.train import loop
    from dcanet_tpu_torch.train.state import TrainState

    step = loop.train_step

    def unchanged(self):
        self.step += 1

    def half_batch(state, batch, cfg):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, cfg)

    def altered_loss(state, batch, cfg):
        metrics = step(state, batch, cfg)
        return dict(metrics, total=metrics["total"] * 1.05)

    return {"state_unchanged": (TrainState, "apply_gradients", unchanged),
            "half_batch": (loop, "train_step", half_batch),
            "altered_loss": (loop, "train_step", altered_loss)}


def test_a_sound_tiny_train_run_is_correct(tmp_path):
    cell = tiny_cell(tmp_path, "dcanet.train-kitti.bf16", TINY_DCANET, TINY_TRAIN)
    assert _correct(cell, train.run(cell, SEED, 0.3, False, "cpu"))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_loss"])
def test_a_fault_fails_the_train_cell(fault, tmp_path, monkeypatch):
    cell = tiny_cell(tmp_path, "dcanet.train-kitti.bf16", TINY_DCANET, TINY_TRAIN)
    monkeypatch.setattr(*_train_faults()[fault])
    assert not _correct(cell, train.run(cell, SEED, 0.3, False, "cpu"))

