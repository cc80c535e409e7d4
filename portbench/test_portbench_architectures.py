"""CPU tests of a new architecture taken as added files (run: python -m pytest portbench -q).

A configuration file may name its own reference module
(`"reference": "<module>"`, portbench/reference/<module>.py) and the
program's settings (`"program": {...}`, keyword arguments of `make_model`).
Here: a throwaway architecture added to a copy of the benchmark as new files
runs a serving cell to `correct` on the CPU; each breach of the reference
module's contract (`stereo.named_reference`) and a program setting the model
does not run are refused; the weight rules take the new leaf kinds; the
values the existing configurations read are the parent commit's, frozen;
and no reference module loads JAX or the port.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.lib import flops, manifest  # noqa: E402
from portbench.lib.weights import load_into_program, seeded_state_dict  # noqa: E402
from portbench.reference import stereo  # noqa: E402

SEED = 2**31 + 91

# ---- a throwaway architecture, found from added files only ----

THROWAWAY_REFERENCE = '''"""GwcNet-gc's plain reference under a new architecture's name."""

from portbench.reference import stereo

WIDTHS = ("num_groups", "concat_channels", "base_channels")
FIXED_WIDTHS = {"feature_channels": 320, "hourglasses": 3}


def from_config(config):
    return stereo.GwcNetGC(maxdisp=config["maxdisp"], groups=config["num_groups"],
                           concat_channels=config["concat_channels"], base=config["base_channels"])
'''
THROWAWAY_CONFIG = {
    "name": "throwaway", "source": "a test's", "arch": "throwaway-net", "reference": "throwaway",
    "model": "gwcnet-gc", "program": {"stacked_features": False, "num_groups": 40}, "maxdisp": 32,
    "num_groups": 40, "concat_channels": 12, "base_channels": 32, "feature_channels": 320, "hourglasses": 3,
    "layers": {"feature_extraction": "features"},
}
THROWAWAY_TRAFFIC = {"kind": "serve", "dtype": "float32", "image_hw": [30, 62], "input_hw": [32, 64], "pool": 2,
                     "disp_range": [1.0, 12.0], "check_share": 1.0, "trace_requests": 2}
CELL = "throwaway.serve-tiny"

# run from the copy's root, so that `portbench` is the copy's; the port is the repository's
RUN_THE_CELL = f'''
import json, sys
from pathlib import Path
from portbench.drivers import serve
from portbench.lib import compare, flops, inputs, manifest
from portbench.reference import stereo
root = Path.cwd()
assert Path(stereo.__file__).resolve().is_relative_to(root.resolve()), stereo.__file__
cell = manifest.Cell(manifest.load_benchmark(root), {CELL!r}, root)
net = stereo.from_config(cell.config)
pairs = inputs.serve_pairs({SEED}, cell.traffic)
state = serve.weights(cell.config, {SEED}, pairs, "cpu")
res = serve.run(cell, {SEED}, 0.5, False, "cpu")
print(json.dumps({{"net": type(net).__name__, "state": sorted(state) == sorted(net.state_dict()),
                  "ops": flops.count(cell.config, 1, tuple(cell.traffic["input_hw"]), False),
                  "correct": compare.judge(res["numbers"], cell.limits)[0], "numbers": res["numbers"],
                  "requests": res["attempted"]}}))
'''


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_throwaway_architecture_is_found_from_added_files_and_is_correct(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "reference" / "throwaway.py").write_text(THROWAWAY_REFERENCE)
    (pb / "configs" / "throwaway.json").write_text(json.dumps(THROWAWAY_CONFIG))
    (pb / "traffic" / "serve-tiny.json").write_text(json.dumps(THROWAWAY_TRAFFIC))
    limits = json.loads((ROOT / "portbench" / "limits" / "dcanet.serve-kitti.f32.json").read_text())
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "x", "file": "portbench/configs/throwaway.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": CELL, "config": "throwaway", "traffic": "serve-tiny", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_pairs_per_s", "serve_ms_p95"):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tmp_path)
    assert [k for k, v in before.items() if after[k] != v] == ["BENCHMARK.json"]

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-c", RUN_THE_CELL], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    builtin = dict(json.loads((ROOT / "portbench" / "configs" / "gwcnet-gc.json").read_text()), maxdisp=32)
    assert got["net"] == "GwcNetGC" and got["state"] and got["requests"] >= 1
    assert got["ops"] == flops.count(builtin, 1, (32, 64), False)
    assert got["correct"], got["numbers"]


# ---- the reference module's contract, each breach refused ----

GOOD = '''
import torch
from torch import nn
from portbench.reference import stereo

WIDTHS = ("base_channels",)
FIXED_WIDTHS = {"feature_channels": 320}


class Net(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv, self.bn, self.head = stereo.Conv2d(3, c, 3, padding=1), stereo.BatchNorm2d(c), stereo.Conv2d(c, 1, 1)

    def forward(self, left, right):
        return self.head(torch.relu(self.bn(self.conv(left - right))))[:, 0], []


def from_config(config):
    return Net(config["base_channels"])
'''
CONFIG = {"name": "probe", "arch": "probe-net", "model": "gwcnet-gc", "maxdisp": 32, "base_channels": 8,
          "feature_channels": 320, "layers": {}, "assumed": {}}


def _module(monkeypatch, tmp_path, name: str, source: str) -> str:
    """`source` as the module portbench/reference/<name>.py for this test."""
    path = tmp_path / f"{name}.py"
    path.write_text(source)
    spec = importlib.util.spec_from_file_location(f"portbench.reference.{name}", path)
    module = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, module)
    spec.loader.exec_module(module)
    return name


# the head a 2D transposed convolution, as a decoder that upsamples has
GOOD_DECONV = GOOD.replace(
    "self.conv, self.bn, self.head = stereo.Conv2d(3, c, 3, padding=1), stereo.BatchNorm2d(c), stereo.Conv2d(c, 1, 1)",
    "self.conv, self.bn = stereo.Conv2d(3, c, 3, stride=2, padding=1), stereo.BatchNorm2d(c)\n"
    "        self.head = stereo.ConvTranspose2d(c, 1, 4, stride=2, padding=1)")


@pytest.mark.parametrize("source", ["GOOD", "GOOD_DECONV"])
def test_a_module_that_keeps_the_contract_is_taken(source, monkeypatch, tmp_path):
    name = _module(monkeypatch, tmp_path, f"probe_{source.lower()}", globals()[source])
    net = stereo.from_config(dict(CONFIG, reference=name))
    assert type(net).__name__ == "Net"
    state = seeded_state_dict(net, 3, "cpu")
    net.load_state_dict(state)
    left, right = torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16)
    stereo.calibrate_bn_(net, left, right)
    assert set(state) == set(net.state_dict()) and float(net.bn.running_var.min()) > 0
    # the control reaches every convolution, the head's included
    assert all(isinstance(m, stereo._Q) for m in (net.conv, net.head))
    with torch.no_grad():
        plain = net(left, right)[0]
        control = stereo.set_fp8(net, True)(left, right)[0]
    assert plain.shape == (1, 8, 16) and 0 < float((plain - control).abs().max()) < 0.5 * float(plain.abs().max())


BREACHES = {
    "imports_the_port": (GOOD + "import dcanet_tpu_torch\n", {}, "imports"),
    "imports_a_function_of_the_port": (GOOD + "from dcanet_tpu_torch.models.registry import make_model\n", {},
                                       "imports"),
    "imports_jax": (GOOD + "import jax\n", {}, "imports"),
    "imports_the_jax_package": (GOOD + "from dcanet_tpu import models\n", {}, "imports"),
    "declares_no_widths": (GOOD.replace('WIDTHS = ("base_channels",)', ""), {}, "WIDTHS"),
    "a_width_it_does_not_build": (GOOD, {"num_heads": 4}, "does not build"),
    "a_fixed_width_at_another_value": (GOOD, {"feature_channels": 256}, "has 320"),
    "a_torch_convolution": (GOOD.replace("stereo.Conv2d(3, c", "nn.Conv2d(3, c"), {}, "other kinds"),
    "a_torch_batchnorm": (GOOD.replace("stereo.BatchNorm2d(c)", "nn.BatchNorm2d(c)"), {}, "other kinds"),
    "a_torch_transposed_convolution": (GOOD_DECONV.replace("stereo.ConvTranspose2d", "nn.ConvTranspose2d"), {},
                                       "other kinds"),
    "a_subclass_of_its_kinds": (GOOD.replace("stereo.Conv2d(3, c", "Conv(3, c") +
                                "\n\nclass Conv(stereo.Conv2d):\n    pass\n", {}, "other kinds"),
    "a_bare_disparity": (GOOD.replace("[:, 0], []", "[:, 0]"), {}, "eval forward"),
    "a_disparity_with_a_channel": (GOOD.replace("[:, 0], []", ", []"), {}, "eval forward"),
}


@pytest.mark.parametrize("breach", sorted(BREACHES))
def test_a_module_that_breaks_the_contract_is_refused(breach, monkeypatch, tmp_path):
    source, extra, says = BREACHES[breach]
    # stand-ins, so that the test process loads neither JAX nor the JAX package
    jax_package = types.ModuleType("dcanet_tpu")
    jax_package.models = types.ModuleType("dcanet_tpu.models")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "dcanet_tpu", jax_package)
    name = _module(monkeypatch, tmp_path, f"probe_{breach}", source)
    with pytest.raises(ValueError, match=says):
        stereo.from_config(dict(CONFIG, reference=name, **extra))


@pytest.mark.parametrize("reference", ["stereo", "no such module", 7])
def test_a_reference_that_names_no_other_module_is_refused(reference):
    with pytest.raises(ValueError, match="names no module"):
        stereo.from_config(dict(CONFIG, reference=reference))


@pytest.mark.parametrize("program, says", [({"stacked_features": False}, "stacked_features is True"),
                                           ({"iters": 32}, "iters is None"),
                                           ({"num_groups": 40, "stacked_features": True}, None)])
def test_a_program_setting_the_model_does_not_run_is_refused(program, says):
    from dcanet_tpu_torch.models.registry import make_model

    config = dict(json.loads((ROOT / "portbench" / "configs" / "gwcnet-gc.json").read_text()), maxdisp=32,
                  program=program)
    with torch.device("meta"):
        layout = stereo.from_config(config)
    model = make_model(config["model"], maxdisp=config["maxdisp"])  # the port's defaults, not the file's settings
    state = seeded_state_dict(layout, 5, "cpu")
    if says is None:
        assert load_into_program(model, state, config) is model
    else:
        with pytest.raises(ValueError, match=says):
            load_into_program(model, state, config)


@pytest.mark.parametrize("key", ["reference", "program"])
def test_a_train_cell_of_a_new_architecture_is_refused(key):
    from portbench.drivers import train

    real = manifest.Cell(manifest.load_benchmark(ROOT), "dcanet.train-kitti.bf16", ROOT)
    # cut small, so that a step taken in place of the refusal fails fast
    config = dict(real.config, model="dcanet-cva1", num_cva=1, maxdisp=32,
                  **{key: {"program": {}, "reference": "throwaway"}[key]})
    traffic = dict(real.traffic, batch=1, crop_hw=[32, 64], disp_range=[1.0, 12.0], pool=1, checked_steps=1)
    with pytest.raises(ValueError, match="loss contract"):
        train.reference_steps(config, traffic, SEED, "cpu")


# ---- weight rules for the new leaf kinds ----

def test_linear_and_affine_norm_leaves_are_drawn_by_their_rules():
    nn = torch.nn
    net = nn.ModuleDict({"linear": nn.Linear(512, 256), "group": nn.GroupNorm(8, 4096), "layer": nn.LayerNorm(4096),
                         "instance": nn.InstanceNorm2d(4096, affine=True, track_running_stats=True)})
    sd = seeded_state_dict(net, SEED, "cpu")
    assert set(sd) == set(net.state_dict())
    mean_std = lambda t: (float(t.mean()), float(t.std()))  # noqa: E731
    assert mean_std(sd["linear.weight"]) == (pytest.approx(0.0, abs=3e-3), pytest.approx((2 / 512) ** 0.5, rel=0.02))
    assert mean_std(sd["linear.bias"])[1] == pytest.approx(0.05, rel=0.2)
    for norm in ("group", "layer", "instance"):
        assert mean_std(sd[f"{norm}.weight"]) == (pytest.approx(1.0, abs=5e-3), pytest.approx(0.05, rel=0.05))
        assert mean_std(sd[f"{norm}.bias"]) == (pytest.approx(0.0, abs=5e-3), pytest.approx(0.05, rel=0.05))
    assert float(sd["instance.running_var"].min()) >= 1.0
    with pytest.raises(KeyError, match="no rule"):
        seeded_state_dict(nn.Embedding(4, 4), SEED, "cpu")


# ---- what the existing configurations read, frozen at the parent commit ----

# seeded_state_dict(layout, 5, "cpu") digested by _state_digest, and flops.count: computed with
# this file's functions on the harness before configurations could name a reference module
FROZEN = {
    "dcanet": {"state": "99f61921a2e3cc44543f3d916199f8f105f46e1e4aca039c15f5fe940c973d40",
               "serve_ops": 1275711750144, "train_ops": 18160463904768},
    "gwcnet-gc": {"state": "cafa34a129dfc782ee8e3cd9dacd5f8253dfb591d2ce3a2760ec074ef8230147",
                  "serve_ops": 1274082361344},
}


def _state_digest(sd: dict) -> str:
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(str(v.dtype).encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _config(name: str) -> dict:
    entry = next(c for c in manifest.load_benchmark(ROOT)["configs"] if c["name"] == name)
    return json.loads((ROOT / entry["file"]).read_text())


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_the_seeded_weights_are_the_parents(name):
    with torch.device("meta"):
        layout = stereo.from_config(_config(name))
    assert _state_digest(seeded_state_dict(layout, 5, "cpu")) == FROZEN[name]["state"]


@pytest.mark.parametrize("name, batch, hw, train", [("dcanet", 1, (384, 1248), False),
                                                    ("gwcnet-gc", 1, (384, 1248), False),
                                                    ("dcanet", 12, (256, 512), True)])
def test_the_operation_counts_are_the_parents(name, batch, hw, train):
    assert flops.count(_config(name), batch, hw, train) == FROZEN[name]["train_ops" if train else "serve_ops"]


# ---- no reference module loads JAX or the port ----

# in a fresh process: the module imported, and every configuration of BENCHMARK.json that it serves
# built and run once on the meta device (imports inside functions then run too)
BUILD_EACH = """
import json, sys, torch
from pathlib import Path
from portbench.lib import manifest
from portbench.reference import stereo
module = sys.argv[1]
__import__("portbench.reference." + module)
for entry in manifest.load_benchmark(Path.cwd())["configs"]:
    config = json.loads(Path(entry["file"]).read_text())
    if config.get("reference", "stereo") == module:
        with torch.device("meta"), torch.no_grad():
            stereo.from_config(config).eval()(torch.empty(1, 3, 64, 128), torch.empty(1, 3, 64, 128))
        print("built", entry["name"], file=sys.stderr)
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("module", sorted(p.stem for p in (ROOT / "portbench" / "reference").glob("*.py")
                                          if p.stem != "__init__"))
def test_a_reference_module_and_its_networks_load_no_jax_and_no_port(module):
    run = subprocess.run([sys.executable, "-c", BUILD_EACH, module], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = set(run.stdout.split())
    assert "torch" in loaded and not loaded & stereo.forbidden(), loaded & stereo.forbidden()
    if module == "stereo":
        assert run.stderr.count("built") == len(manifest.load_benchmark(ROOT)["configs"])
