"""CPU tests of the benchmark's harness (run: python -m pytest portbench -q).

The manifest's required shape, discovery of a cell, a mix and
a metric added as new files, the imports of the harness and the
reference, the window's statistics and the trace's reduction. The test
that needs a card carries the `cuda` marker and skips without one.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.lib import manifest, window  # noqa: E402
from portbench.lib.trace import summarize  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench() -> dict:
    return manifest.load_benchmark(ROOT)


def test_manifest_has_the_required_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_every_cell_names_its_files_and_reports_enough(cell):
    c = manifest.Cell(_bench(), cell, ROOT)
    assert c.traffic["kind"] in ("serve", "train")
    assert c.limits, f"no limits for {cell}"
    e2e = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = c.per_layer()
    assert layer and all(m["moves"] in e2e for m in layer)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_mix_and_metric_are_found_as_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (tmp_path / "portbench" / "configs" / "throwaway.json").write_text(json.dumps({"arch": "dcanet", "maxdisp": 96}))
    (tmp_path / "portbench" / "traffic" / "serve-tiny.json").write_text(json.dumps({"kind": "serve", "pool": 2}))
    (tmp_path / "portbench" / "metrics" / "answer.serve.py").write_text("def read(ctx):\n    return 42.0\n")
    (tmp_path / "portbench" / "limits" / "throwaway.serve-tiny.json").write_text(json.dumps({"disp_mean_gap_px": 1}))
    bench["configs"].append({"name": "throwaway", "source": "x", "file": "portbench/configs/throwaway.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "throwaway.serve-tiny", "config": "throwaway", "traffic": "serve-tiny",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "answer.serve", "unit": "%", "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "serve_ms_p95"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_pairs_per_s", "serve_ms_p95"):
            m["workloads"].append("throwaway.serve-tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tmp_path)
    assert all(after[k] == v for k, v in before.items() if k != "BENCHMARK.json")

    cell = manifest.Cell(manifest.load_benchmark(tmp_path), "throwaway.serve-tiny", tmp_path)
    assert cell.config["maxdisp"] == 96 and cell.traffic["pool"] == 2 and cell.limits == {"disp_mean_gap_px": 1}
    layer = [m["name"] for m in cell.per_layer()]
    assert "answer.serve" in layer and "gwc_fwd_roofline.train" not in layer
    assert manifest.metric_reader("answer.serve", tmp_path)({}) == 42.0
    # a metric without a `workloads` list goes to every cell that reports its end-to-end metric
    assert "answer.serve" in [m["name"] for m in manifest.Cell(manifest.load_benchmark(tmp_path),
                                                               "dcanet.serve-kitti.f32", tmp_path).per_layer()]


def _loaded_after(code: str) -> set:
    probe = code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))


FORBIDDEN = {"jax", "jaxlib", "flax", "dcanet_tpu"}


def test_the_harness_loads_no_jax_and_the_reference_no_program():
    metrics = sorted(p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py"))
    harness = (
        "import importlib.util, json, pathlib, runpy\n"
        "runpy.run_path('portbench/run.py', run_name='portbench_run')\n"
        "from portbench.lib import manifest\n"
        "import portbench.calibrate, portbench.drivers.serve, portbench.drivers.train\n"
        "for p in pathlib.Path('portbench').glob('*/*.json'): json.loads(p.read_text())\n"
        f"for m in {metrics!r}: manifest.metric_reader(m)\n"
        "from dcanet_tpu_torch import cli\n"
        "from dcanet_tpu_torch.train import loop\n"
        "from dcanet_tpu_torch.models.registry import make_model\n"
    )
    loaded = _loaded_after(harness)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    reference = _loaded_after("import portbench.reference.stereo, portbench.reference.train, portbench.lib.flops")
    assert not reference & (FORBIDDEN | {"dcanet_tpu_torch"})


def test_no_card_no_result(tmp_path):
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dcanet.serve-kitti.f32", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)})
    assert run.returncode != 0 and run.stdout.strip() == ""


@pytest.mark.parametrize("key, value", [("num_groups", 32), ("feature_channels", 256), ("maxdisp", 96)])
def test_a_width_the_program_or_reference_does_not_run_is_refused(key, value):
    import torch

    from dcanet_tpu_torch.models.registry import make_model
    from portbench.lib.weights import load_into_program, seeded_state_dict
    from portbench.reference import stereo

    config = dict(manifest.Cell(_bench(), "dcanet.serve-kitti.f32", ROOT).config, num_cva=1, model="dcanet-cva1")
    with torch.device("meta"):
        layout = stereo.from_config(config)
    state = seeded_state_dict(layout, 5, "cpu")
    with torch.device("meta"):
        model = make_model(config["model"], maxdisp=config["maxdisp"]).to_empty(device="cpu")
    load_into_program(model, state, config)  # the file as the program runs it
    wrong = dict(config, **{key: value})
    with pytest.raises((ValueError, RuntimeError)):
        with torch.device("meta"):
            layout = stereo.from_config(wrong)
        load_into_program(model, seeded_state_dict(layout, 5, "cpu"), wrong)


def test_window_rate_and_tail_take_every_request_and_the_stall_shows():
    starts = [0.1 * i for i in range(100)]
    ends = [s + 0.05 for s in starts]
    ends[60] += 2.0  # one request stalls for two seconds inside the window
    stats = window.serve_summary(starts, ends, 0.0, 12.0)
    assert stats["requests"] == 100 and stats["pairs_per_s"] == pytest.approx(100 / 12.0)
    assert stats["p95_ms"] == pytest.approx(50.0) and stats["max_ms"] == pytest.approx(2050.0)
    assert window.percentile(list(range(1, 101)), 95) == 95
    assert window.percentile([1.0] * 94 + [9.0] * 6, 95) == 9.0  # the tail of all requests, not of chunks
    gap, at = window.longest_stall([1.0, 2.0, 5.5, 6.0], 0.0, 7.0)
    assert gap == pytest.approx(3.5) and at == pytest.approx(2.0)


def test_trace_busy_time_is_a_union_and_gaps_name_the_host():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("k3", 20.0, 30.0)]
    host = [("aten::conv2d", 11.0, 19.0), ("cudaLaunchKernel", 14.0, 16.0)]
    s = summarize(device, host)
    assert s["window_s"] == pytest.approx(30e-6) and s["busy_s"] == pytest.approx(22e-6)
    assert s["idle_gaps"][0] == ["cudaLaunchKernel", pytest.approx(8e-6)]
    assert s["ops"]["k2"] == [1, pytest.approx(7e-6)]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dcanet.serve-kitti.f32", "--seed", "7",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert run.returncode == 0 and line["correct"] and line["device"]["platform"] == "gpu"
