"""The port stands alone: importing dcanet_tpu_torch, every submodule of it,
and chip_smoke.py loads no JAX, no flax, nothing of dcanet_tpu and nothing of
tools/. Checked in a fresh interpreter, since this test process imports JAX.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import dcanet_tpu_torch
names = ["dcanet_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(dcanet_tpu_torch.__path__, "dcanet_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


@pytest.fixture(scope="module")
def probe():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_submodule_imports(probe):
    expected = {
        "dcanet_tpu_torch.cli", "dcanet_tpu_torch.weights", "dcanet_tpu_torch.models.dcanet",
        "dcanet_tpu_torch.kernels.gwc", "dcanet_tpu_torch.nn.cva", "dcanet_tpu_torch.data.io",
        "dcanet_tpu_torch.kernels.conv3d", "dcanet_tpu_torch.config", "dcanet_tpu_torch.losses",
        "dcanet_tpu_torch.ops.disp2prob", "dcanet_tpu_torch.train.checkpoint", "dcanet_tpu_torch.train.loop",
        "dcanet_tpu_torch.train.metrics", "dcanet_tpu_torch.train.schedule", "dcanet_tpu_torch.train.state",
        "dcanet_tpu_torch.data.augment", "dcanet_tpu_torch.data.datasets", "dcanet_tpu_torch.data.loader",
        "dcanet_tpu_torch.data.synthetic",
    }
    assert expected <= set(probe["imported"])


@pytest.mark.parametrize("forbidden", ["jax", "flax", "dcanet_tpu", "tools"])
def test_no_forbidden_module_loaded(probe, forbidden):
    # exact-prefix match: "dcanet_tpu_torch" must not count as "dcanet_tpu"
    hits = [m for m in probe["modules"] if m == forbidden or m.startswith(forbidden + ".")]
    assert not hits, hits
