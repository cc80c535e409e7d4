"""The port's spans and counters (dcanet_tpu_torch/utils/profiling.py), on
the CPU.

- With no profiler recording, a span is the shared no-op context and the
  registry stays empty.
- Under `torch.profiler.profile(activities=[CPU])`: `cli._forward` on a
  small DCANet and GwcNet-gc records the serve.request tree (one root, each
  span's parent the one open around it, self time within total), whose
  names the profiler's own events carry as plain ranges, not user
  annotations; `train_step` records the train.step tree.
- The counters: the BatchNorm fold's lookups and rebuilds, the all-reduces
  and their bytes (a one-rank gloo group), the waits on the loader, the
  kernels' launch counts, `reset_counters`; `cli train`'s printed line and
  train_log.jsonl rows carry the data wait share and the all-reduces per
  step; `trace(logdir)` writes spans.json.
- Importing utils/profiling loads no module beyond torch's and the port's.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from dcanet_tpu_torch import cli
from dcanet_tpu_torch.data import loader
from dcanet_tpu_torch.kernels import conv3d, gwc
from dcanet_tpu_torch.models import DCANet, GwcNetBaseline
from dcanet_tpu_torch.nn import layers
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.parallel import distributed
from dcanet_tpu_torch.train import loop
from dcanet_tpu_torch.train.state import create_train_state
from dcanet_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MAXDISP, H, W = 32, 32, 64
MODEL_STAGES = {"model.features", "model.cost_volume", "model.aggregation", "model.regression"}


@pytest.fixture(autouse=True)
def _fresh_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _pair(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((H, W, 3)).astype(np.float32) for _ in range(2)]


def _dcanet(num_cva=1):
    return reference_init_(DCANet(maxdisp=MAXDISP, num_cva=num_cva), torch.Generator().manual_seed(0)).eval()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def test_spans_record_nothing_with_the_profiler_off():
    model = _dcanet()
    assert profiling.span("a") is profiling.span("b", torch.device("cpu"))  # the shared no-op context
    cli._forward(model, *_pair(0), False)
    assert profiling.span_summary()["spans"] == {} and profiling.span_records() == []
    with profiling.span("serve.request"):
        pass
    assert profiling.span_records() == []


@pytest.mark.parametrize("name", ["dcanet", "gwcnet-gc"])
def test_a_request_records_its_tree_as_plain_profiler_ranges(name):
    model = _dcanet() if name == "dcanet" else \
        reference_init_(GwcNetBaseline(maxdisp=MAXDISP), torch.Generator().manual_seed(0)).eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in range(2):
            cli._forward(model, *_pair(seed), False)
    records = profiling.span_records()
    spans = _by_name(records)
    roots = spans["serve.request"]
    assert len(roots) == 2 and all(r["parent"] is None and r["root"] == r["id"] for r in roots)
    stages = MODEL_STAGES | ({"model.guidance", "model.propagation"} if name == "dcanet" else set())
    assert set(spans) == {"serve.request", "serve.h2d", "serve.d2h", "model.forward"} | stages
    by_id = {r["id"]: r for r in records}
    for r in records:
        if r["name"] == "serve.request":
            continue
        parent = by_id[r["parent"]]
        want = "model.forward" if r["name"] in stages else "serve.request"
        assert parent["name"] == want, r
        assert r["root"] == by_id[parent["root"]]["id"] and by_id[r["root"]]["name"] == "serve.request"
        assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"]
    summary = profiling.span_summary()["spans"]
    assert summary["serve.request"]["count"] == 2 and summary["model.forward"]["count"] == 2
    for entry in summary.values():
        assert 0 <= entry["self_host_ms"] <= entry["host_ms"] and "device_ms" not in entry
    children = sum(summary[s]["host_ms"] for s in ("serve.h2d", "model.forward", "serve.d2h"))
    assert summary["serve.request"]["self_host_ms"] == pytest.approx(summary["serve.request"]["host_ms"] - children)

    events = [e for e in prof.events() if e.name in spans]
    assert {e.name for e in events} == set(spans)
    assert not any(e.is_user_annotation for e in events)
    assert len([e for e in events if e.name == "serve.request"]) == 2


def test_a_train_step_records_its_tree():
    model = reference_init_(DCANet(maxdisp=MAXDISP, num_cva=1), torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda step: 1e-3)
    rng = np.random.default_rng(0)
    batch = {"left": torch.from_numpy(rng.standard_normal((1, 3, H, W)).astype(np.float32)),
             "right": torch.from_numpy(rng.standard_normal((1, 3, H, W)).astype(np.float32)),
             "disparity": torch.from_numpy(rng.uniform(1.0, MAXDISP - 2.0, (1, H, W)).astype(np.float32))}
    with profile(activities=[ProfilerActivity.CPU]):
        metrics = loop.train_step(state, batch, loop.LossConfig(max_disp=MAXDISP))
    assert np.isfinite(float(metrics["total"]))
    records = profiling.span_records()
    spans = _by_name(records)
    (root,) = spans["train.step"]
    by_id = {r["id"]: r for r in records}
    step_children = {"train.zero_grad", "model.forward", "train.loss", "train.backward", "train.optimizer",
                     "train.metrics"}
    assert {n for n, rs in spans.items() if all(by_id.get(r["parent"], {}).get("name") == "train.step" for r in rs)} \
        == step_children  # no train.all_reduce with one process
    assert all(r["root"] == root["id"] for r in records)
    assert len(spans["model.aggregation"]) == 2 and len(spans["model.regression"]) == 2  # eval heads, then the ladders
    summary = profiling.span_summary()["spans"]
    assert summary["train.step"]["count"] == 1
    assert summary["train.step"]["self_host_ms"] <= summary["train.step"]["host_ms"]


def test_a_second_bf16_eval_forward_hits_the_fold_cache():
    model = _dcanet()
    left, right = (torch.from_numpy(x.transpose(2, 0, 1)[None].copy()) for x in _pair(0))
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
        model(left, right)
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            model(left, right)
    counts = profiling.counters()
    assert counts["fold.lookups"] > 0 and counts["fold.rebuilds"] == 0
    assert counts["fold.lookups"] == layers.FOLD_LOOKUPS
    lookup = profiling.span_summary()["spans"]["fold.lookup"]
    assert lookup["count"] == counts["fold.lookups"] and lookup["host_ms"] > 0


def test_counters_gather_the_kernels_launch_counts(monkeypatch):
    monkeypatch.setattr(gwc, "LAUNCHES", 3)
    monkeypatch.setattr(gwc, "BACKWARD_LAUNCHES", 2)
    monkeypatch.setitem(gwc.LAUNCHES_BY_DTYPE, "bfloat16", 3)
    monkeypatch.setattr(conv3d, "LAUNCHES", 5)
    monkeypatch.setattr(conv3d, "BF16_LAUNCHES", 4)
    counts = profiling.counters()
    assert (counts["gwc.launches"], counts["gwc.backward_launches"], counts["gwc.launches_by_dtype.bfloat16"],
            counts["conv3d.launches"], counts["conv3d.bf16_launches"]) == (3, 2, 3, 5, 4)
    profiling.reset_counters()
    assert gwc.LAUNCHES == conv3d.LAUNCHES == conv3d.BF16_LAUNCHES == gwc.LAUNCHES_BY_DTYPE["bfloat16"] == 0
    assert not any(profiling.counters().values())


def test_all_reduces_and_their_bytes_are_counted(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'group'}", world_size=1, rank=0)
    try:
        profiling.reset_counters()
        t = torch.ones(6, dtype=torch.float32)
        assert distributed.all_reduce_(t) is t and torch.equal(t, torch.ones(6))
        distributed.all_reduce_(torch.ones(3, dtype=torch.float64))
    finally:
        dist.destroy_process_group()
    counts = profiling.counters()
    assert counts["collective.all_reduce"] == 2 and counts["collective.all_reduce_bytes"] == 6 * 4 + 3 * 8


def test_waits_on_the_loader_are_counted():
    def slow():
        for i in range(3):
            time.sleep(0.02)
            yield i

    profiling.reset_counters()
    assert list(loader.waited(slow())) == [0, 1, 2]
    counts = profiling.counters()
    assert counts["data.batches"] == 3 and counts["data.wait_s"] >= 0.06


def test_cli_train_logs_the_data_wait_and_all_reduces(tmp_path, monkeypatch, capsys):
    from dcanet_tpu_torch.data import datasets
    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree

    monkeypatch.setitem(datasets.PRESETS, "sceneflow", dict(datasets.PRESETS["sceneflow"], crop=(32, 64)))
    root = write_sceneflow_tree(tmp_path / "sceneflow", 4, (48, 96), seed=0, max_disp=24)
    logdir = tmp_path / "run"
    profiling.reset_counters()
    cli.main(["train", "--preset", "sceneflow", "--data-root", str(root), "--logdir", str(logdir), "--maxdisp", "32",
              "--batch-size", "2", "--num-workers", "2", "--print-freq", "1", "--seed", "3", "--device", "cpu",
              "--epochs", "1"])
    assert "pairs/s) data wait " in capsys.readouterr().out
    rows = [json.loads(line) for line in (logdir / "train_log.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(0 < r["data_wait_share"] < 1 and r["all_reduces_per_step"] == 0 for r in rows)
    assert profiling.counters()["data.batches"] == 2


def test_trace_writes_the_spans_beside_the_trace(tmp_path):
    model = _dcanet()
    with profiling.trace(str(tmp_path)):
        cli._forward(model, *_pair(0), False)
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
    written = json.loads((tmp_path / "spans.json").read_text())
    assert written["spans"]["serve.request"]["count"] == 1 and "fold.lookups" in written["counters"]
    assert {r["name"] for r in written["records"]} >= {"serve.request", "model.forward", "model.cost_volume"}


def test_the_span_module_imports_nothing_beyond_torch():
    probe = ("import sys, json, torch\nbefore = set(sys.modules)\nimport dcanet_tpu_torch.utils.profiling\n"
             "print(json.dumps(sorted(set(sys.modules) - before)))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == [
        "dcanet_tpu_torch", "dcanet_tpu_torch.utils", "dcanet_tpu_torch.utils.profiling"]
