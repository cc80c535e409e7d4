"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json; its configuration,
traffic mix, limits and per-layer metrics are files under portbench/ found
by name (portbench/lib/manifest.py). The run makes its inputs and weights
from the seed, warms the cell's shapes (set-up), measures for `--seconds`,
then holds what the timed path produced against the plain reference. The
last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared beside its limit; the same numbers are the
last lines of standard error.

It exits non-zero and prints no result without as many CUDA cards as the
cell asks for, or when JAX, flax or the JAX package is loaded at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "_portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "dcanet_tpu")


def _env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library may load JAX or flax on its own."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e30


def result_line(cell, res: dict, trace: bool, device: dict, correct: bool, checks: dict) -> dict:
    from portbench.lib import manifest

    if trace:
        metrics = {}
        ctx = {"cell": cell, **res["layer"], "window": res["window"]}
        for m in cell.per_layer():
            value = manifest.metric_reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["metrics"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end()}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
            "device": device}
    if trace:
        tr = res["layer"]["trace"]
        line["device"] = dict(device, busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]} for k, v in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    sys.path.insert(0, str(ROOT))
    from portbench.lib import compare, manifest

    cell = manifest.Cell(manifest.load_benchmark(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    import importlib

    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    correct, checks = compare.judge(res["numbers"], cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = result_line(cell, res, bool(args.trace), device, correct, checks)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the result's process: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
