"""The readings a cell's correctness limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... --control-seeds 3 [--seconds 2]
        [--witness] [--dump DIR]

For every seed: the program's numbers, as a run of `--seconds` computes
them (portbench/lib/compare.py). For the first `--control-seeds` seeds
also the control's, the reference computed one precision below the cell's
dtype in the program's place (TF32 for float32, float8 for bfloat16), and
in training cells the reference with half of each batch left out. With
`--witness` a training cell also reads the reference under bf16 autocast
in the program's place: a second implementation at the program's
precision, which tells a reading that bf16 rounding makes from one that
only the program makes. `--dump DIR` writes every leaf's norms of each
seed (gradient, change, size) to DIR/<seed>.json. One JSON line each goes
to standard output; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.drivers import serve, train  # noqa: E402
from portbench.lib import compare, inputs, manifest  # noqa: E402


def worst_leaves(got: dict, want: dict, sizes: dict, keys=None, n: int = 4) -> list:
    """The n leaves of `keys` (default all) whose norms differ most, in
    _worst_leaf's measure: [name, gap, got, want, elements], then the median leaf."""
    keys = list(want) if keys is None else keys
    median = statistics.median(want[k] for k in keys)
    gaps = sorted(((abs(got.get(k, 0.0) - want[k]) / max(want[k], median), k) for k in keys), reverse=True)
    return [[k, g, got.get(k, 0.0), want[k], sizes[k]] for g, k in gaps[:n]] + [["median leaf", median]]


def serve_seed(cell, seed: int, seconds: float, control: bool, program: bool = True) -> list:
    rows = []
    if program:
        res = serve.run(cell, seed, seconds, False)
        rows.append({"kind": "program", "numbers": res["numbers"], "requests": res["attempted"]})
    if control:
        dev = torch.device("cuda")
        pairs = inputs.serve_pairs(seed, cell.traffic)
        state = serve.weights(cell.config, seed, pairs, dev)
        ref = serve.reference_disparities(cell.config, state, pairs, dev)
        low = {"float32": {"tf32": True}, "bfloat16": {"fp8": True}}[cell.traffic["dtype"]]
        ctrl = serve.reference_disparities(cell.config, state, pairs, dev, **low)
        rows.append({"kind": "control", "numbers": compare.serve_numbers(list(enumerate(ctrl)), ref)})
    return rows


def train_seed(cell, seed: int, seconds: float, control: bool, program: bool = True, witness: bool = False,
               dump: str = None) -> list:
    dev = torch.device("cuda")
    sizes = {k: p.numel() for k, p in train._layout(cell.config).named_parameters()}
    others = []
    if program:
        others.append(("program", train.program_run(cell, seed, seconds, False)))
        torch.cuda.empty_cache()
    ref = train.reference_steps(cell.config, cell.traffic, seed, dev)
    if witness:
        others.append(("witness:bf16", train.reference_steps(cell.config, cell.traffic, seed, dev, amp=torch.bfloat16)))
    if control:
        others += [(kind, train.reference_steps(cell.config, cell.traffic, seed, dev, **kw))
                   for kind, kw in (("control", {"fp8": True}), ("fault:half_batch", {"half_batch": True}))]
    median = statistics.median(ref["grad_norms"].values())
    moved = [k for k in ref["change_norms"] if ref["grad_norms"].get(k, 0.0) >= 1e-3 * median]
    rows = [{"kind": kind, "numbers": compare.train_numbers(other, ref), "losses": [other["losses"], ref["losses"]],
             "grad_leaves": worst_leaves(other["grad_norms"], ref["grad_norms"], sizes),
             "change_leaves": worst_leaves(other["change_norms"], ref["change_norms"], sizes, moved)}
            for kind, other in others]
    if dump:
        keep = ("grad_norms", "change_norms", "losses")
        Path(dump).mkdir(parents=True, exist_ok=True)
        Path(dump, f"{seed}.json").write_text(json.dumps(
            {"sizes": sizes, "moved": moved, "reference": {k: ref[k] for k in keep},
             **{kind: {k: other[k] for k in keep} for kind, other in others}}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--witness", action="store_true", help="training: the reference under bf16 autocast too")
    ap.add_argument("--dump", help="training: a directory for every leaf's norms of each seed")
    ap.add_argument("--control-only", action="store_true", help="the control's and faults' readings alone")
    a = ap.parse_args(argv)
    cell = manifest.Cell(manifest.load_benchmark(ROOT), a.workload, ROOT)
    one = {"serve": serve_seed, "train": train_seed}[cell.traffic["kind"]]
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        kw = {"program": False} if a.control_only else {}
        if cell.traffic["kind"] == "train":
            kw.update(witness=a.witness, dump=a.dump)
        for row in one(cell, seed, a.seconds, i < a.control_seeds, **kw):
            print(json.dumps({"workload": cell.name, "seed": seed, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
