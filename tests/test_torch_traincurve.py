"""`python -m dcanet_tpu_torch.traincurve` on the CPU: a tiny procedural tree
(4 TRAIN + 2 TEST scenes at 48x96, `write_procedural_sceneflow_tree`), the
sceneflow preset's crop cut to 32x64, two epochs at batch 2 in bf16 with a
metric read every step: one row per point (epoch 0 the random init), the
steps of each epoch, finite scores, the train rows' ms/step and peak memory
("not measured" on the CPU), the JSON written; epoch 2 resumes from epoch
1's checkpoint (steps 2-3)."""

import json
import math

import torch

from dcanet_tpu_torch import traincurve
from dcanet_tpu_torch.data import datasets
from dcanet_tpu_torch.data.synthetic import write_procedural_sceneflow_tree

torch.set_num_threads(2)


def test_traincurve_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(datasets.PRESETS, "sceneflow", dict(datasets.PRESETS["sceneflow"], crop=(32, 64)))
    root = write_procedural_sceneflow_tree(tmp_path / "tree", 4, 2, (48, 96), seed=1, workers=1)
    out, logdir = tmp_path / "curve.json", tmp_path / "run"
    args = ["--root", str(root), "--batch", "2", "--dtype", "bfloat16", "--logdir", str(logdir),
            "--device", "cpu", "--print-freq", "1", "--num-workers", "2"]
    traincurve.main(args + ["--epochs", "2", "--out", str(out)])
    result = json.loads(out.read_text())
    assert (result["batch"], result["dtype"], result["device"]) == (2, "bfloat16", "cpu")
    curve = result["curve"]
    assert [(r["epoch"], r["steps"]) for r in curve] == [(0, 0), (1, 2), (2, 4)]
    for r in curve:
        assert all(math.isfinite(r[k]) for k in ("val_epe", "val_d1", "val_thres1")), r
    for r in curve[1:]:
        assert r["train_steps"] == 2 and math.isfinite(r["train_loss_last"])
        assert r["ms_per_step"] > 0 and r["pairs_per_s"] > 0 and r["peak_memory_bytes"] == "not measured"
    assert sum(line.startswith("CURVE ") for line in capsys.readouterr().out.splitlines()) == 3
    assert sorted(p.name for p in (logdir / "ckpt").iterdir()) == ["ckpt_00000002.pt", "ckpt_00000004.pt"]
