"""Disparity-sharded training of the Middlebury preset on the CPU: ranks
under gloo on (data, disp) grids against one process, and against the JAX
package.

The setup: the `middlebury` preset (the smooth-L1 ladder on the dense gt,
Adam on `epoch_decay_schedule(1e-3, "12,20,24,28:2")`), DCANet(num_cva=1)
from seeded flax variables (`weights.from_jax_variables`, drawn as in
tests/test_torch_train.py), on crops of halved procedural MiddEval3 scenes
(`write_procedural_middlebury_tree`, the preset's training transform with
the crop cut), two cases (CASES):
- `d60`: the preset's maxdisp 240 on one 16x256 crop: D = 60 at 1/4 and
  W/4 = 64 columns, so that every plane has columns (w >= d) and the disp
  ranks take the card's ranges: [0, 30) and [30, 60) on 2 ranks, [0, 16),
  [16, 32), [32, 46) and [46, 60) on 4 (`DispPlan.split`: 30 plane pairs,
  15 / 15 and 8 / 8 / 7 / 7); the scenes' disparities pass 240 after the
  halving, which the mask drops;
- `d12`: maxdisp 48 on a batch of 2 crops at 32x64 (D = 12: 3 / 3 and
  2 / 2 / 1 / 1 plane pairs), tests/test_torch_middlebury_train.py's scale.

- One train step on the grids (1, 2) and (1, 4) in float64 against one
  process, at tests/test_torch_disp_train.py's bounds: loss terms within
  1e-7 relative, grad norm 1e-6 (summed in float32), every parameter's
  gradient within 1e-7 relative in L2 (to max(its norm, 1e-6 of the
  whole)), BatchNorm running statistics within 1e-10 scaled by max(|x|,
  1); the ranks' metrics equal and summed gradients bit-equal; each rank
  built the gwc volume of its own planes.
- The (1, 2) step at D = 60 in f32 against the JAX package's `train_step`
  under a (1, 2) mesh with `constrain_volume=make_disp_constraint(mesh)`
  on the conftest's 8 virtual CPU devices, from the same flat variables,
  as tests/test_torch_disp_train.py builds it: loss terms rtol 1e-4, EPE
  atol 2e-2, the train forward's disparities within 2e-2 px (and within
  2e-2 px of one process's float64 disparities); the grad norm
  rtol 1e-3 of the float64 gradient's norm (one process's, which
  tests/test_torch_middlebury_train.py holds to the JAX package's float64
  gradient), the JAX f32 step's own norm printed beside it: at maxdisp 240
  an f32 gradient strays from float64 by more than the rounding of one
  norm (PERF.md §6). Against one process in f32: loss terms rtol
  1e-5, grad norm 1e-3.
- `cli train --preset middlebury --n-disp-shards 2 --model dcanet-cva1` at
  maxdisp 240 (the crop cut to 16x256) over 2 ranks (the group formed from
  the DCANET_* variables) against one process, in float64 (the model made
  in float64, each batch cast to it), one epoch of 2 scenes: every step's
  record and every `metrics.jsonl` row within 1e-7 (grad_norm 1e-6), the
  ranks' records equal, rank 1 writing no file, the replicas bit-equal at
  the end, the ranks' gwc volumes of 30 planes each.

The ranks are children of `tests/test_torch_disp_sharding.py`'s harness,
each joined within its CHILD_TIMEOUT_S and killed after it. This module
imports no JAX at its top, because the children import it.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import _grads_digest, state_digest, writes_under
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.data import datasets as tds
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.models import dcanet as tdcanet
from dcanet_tpu_torch.parallel import distributed, make_disp_constraint, make_mesh
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.state import create_train_state
from test_torch_disp_sharding import _join_ranks, _start_ranks
from test_torch_parallel import _steps_in

torch.set_num_threads(2)

LR_SPEC, STEPS_PER_EPOCH = "12,20,24,28:2", 10
# name: (maxdisp, crop, the batch's scenes, full-resolution scene size,
# disparity range, tree seed); d60's crop of scene 1 holds gt past 240
CASES = {
    "d60": (240, (16, 256), (1,), (48, 560), (16.0, 560.0), 53),
    "d12": (48, (32, 64), (0, 1), (90, 170), (8.0, 136.0), 52),
}
GRIDS = ((1, 2), (1, 4))  # (n_data, n_disp)
# each rank's planes [lo, hi) of the D = 60 volume
D60_RANGES = {2: [(0, 30), (30, 60)], 4: [(0, 16), (16, 32), (32, 46), (46, 60)]}
STEP_KEYS = ("total", "smooth_l1", "grad_norm", "epe")
CLI_SCENES = 2


# ---- the ranks ----

def _child(rank, world, cli_port, port, spec_path, out_path):
    """A rank on the CPU, one thread: `cli train` (its group formed by the
    command from the DCANET_* variables), or, in a group formed here, the
    train steps on the whole batch with the disp plan of a (1, world) grid."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    spec = torch.load(spec_path, weights_only=False)
    if spec["job"] == "cli":
        os.environ.update(DCANET_COORDINATOR=f"127.0.0.1:{cli_port}", DCANET_NUM_PROCESSES=str(world),
                          DCANET_PROCESS_ID=str(rank))
        result = _cli_train(spec["root"], spec["logdir"], "--n-disp-shards", str(world))
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
        mesh = make_mesh(1, world)
        result = {"mesh": (mesh.n_data, mesh.n_disp, mesh.rank, mesh.disp_rank),
                  "steps": {case: _step(spec, case, torch.float64, mesh) for case in CASES}}
        if world == 2:
            result["f32"] = _step(spec, "d60", torch.float32, mesh)
        if rank != 0:  # rank 0's gradients stand for the others'; they send their digest
            for res in [*result["steps"].values(), result.get("f32")]:
                if res is not None:
                    res["grads"] = _grads_digest(res["grads"])
    distributed.shutdown()
    torch.save(result, out_path)


@contextlib.contextmanager
def _planes_built(record: list):
    """Within it, each gwc volume that DCANet builds appends its planes
    (lo, hi), the whole volume's included."""
    real = tdcanet.gwc_volume

    def spy(left, right, maxdisp, num_groups, planes=None):
        record.append(tuple(planes) if planes is not None else (0, maxdisp))
        return real(left, right, maxdisp, num_groups, planes)

    tdcanet.gwc_volume = spy
    try:
        yield record
    finally:
        tdcanet.gwc_volume = real


def _step(spec, case, dtype, mesh=None) -> dict:
    """One train step of the case in `dtype` from the spec's weights on the
    case's batch (whole on every rank), with the plan of `mesh`'s disp axis
    (one process: no plan): the metrics, the summed gradients, the BatchNorm
    statistics, the train forward's disparities and the planes of each gwc
    volume built."""
    maxdisp = CASES[case][0]
    plan = None if mesh is None else make_disp_constraint(mesh)
    model = DCANet(maxdisp=maxdisp, num_cva=1, constrain_volume=plan)
    model.load_state_dict(spec["state_dict"], strict=True)
    model = model.to(dtype).train()
    outs = []
    model.register_forward_hook(lambda m, i, out: outs.append(out))
    state = create_train_state(model, tsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    batch = {k: v.to(dtype) for k, v in spec["batches"][case].items()}
    with _planes_built([]) as planes:
        metrics = tloop.train_step(state, batch, tloop.LossConfig(max_disp=maxdisp, preset="smooth_l1"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            "stats": {k: v.clone() for k, v in model.state_dict().items() if "running" in k},
            "disparities": [d.detach().clone() for d in outs[0].disparities], "planes": planes}


# ---- cli train ----

def _train_args(root, logdir, *extra):
    return ["train", "--preset", "middlebury", "--data-root", str(root), "--logdir", str(logdir),
            "--model", "dcanet-cva1", "--maxdisp", str(CASES["d60"][0]), "--batch-size", "1", "--epochs", "1",
            "--num-workers", "1", "--print-freq", "1", "--seed", "3", "--device", "cpu", *extra]


def _cli_train(root, logdir, *extra) -> dict:
    """`cli train --preset middlebury` for one epoch in float64 (the crop
    cut to d60's): the records, the planes of each gwc volume built, the
    paths written under `logdir`, the final state's digest."""
    with pytest.MonkeyPatch.context() as mp, writes_under(str(logdir), []) as written, \
            _steps_in(torch.float64) as states, _planes_built([]) as planes:
        mp.setitem(tds.PRESETS, "middlebury", dict(tds.PRESETS["middlebury"], crop=CASES["d60"][1]))
        hist = cli.main(_train_args(root, logdir, *extra))
    return {"hist": hist, "written": written, "digest": state_digest(states[0]), "planes": planes}


# ---- one process, and the ranks ----

def _tree(base, case):
    from dcanet_tpu_torch.data.synthetic import write_procedural_middlebury_tree

    _, _, n, hw, drange, seed = CASES[case]
    return write_procedural_middlebury_tree(base / case, CLI_SCENES, hw, seed=seed, workers=1,
                                            disp_range=drange)


def _batch(root, case) -> dict:
    """The case's batch of crops through the preset's training transform (the
    scenes halved), NCHW."""
    _, crop, scenes = CASES[case][:3]
    ds = cli.build_dataset(preset("middlebury", data_root=str(root)), training=True)
    ds.cfg = dict(ds.cfg, crop=crop)
    ds.reseed(1)
    samples = [ds[i] for i in scenes]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both grids' ranks and `cli train`'s 2 ranks, started at once;
    meanwhile in this process the one-process steps and `cli train` and the
    JAX step."""
    from test_torch_train import _flat_variables

    tmp = tmp_path_factory.mktemp("middlebury_disp_train")
    roots = {case: _tree(tmp, case) for case in CASES}
    flat = _flat_variables(1, seed=43)
    spec = {"job": "steps", "state_dict": W.from_jax_variables(flat, 1),
            "batches": {case: _batch(roots[case], case) for case in CASES}}
    handles = {grid: _start_ranks(grid[1], spec, tmp / f"grid{grid[0]}x{grid[1]}", "test_torch_middlebury_disp_train")
               for grid in GRIDS}
    handles["cli"] = _start_ranks(2, {"job": "cli", "root": roots["d60"], "logdir": tmp / "two"}, tmp / "cli",
                                  "test_torch_middlebury_disp_train")
    one = {case: _step(spec, case, torch.float64) for case in CASES}
    one_f32 = _step(spec, "d60", torch.float32)
    cli_one = _cli_train(roots["d60"], tmp / "one")
    jax = _jax_step(flat, spec["batches"]["d60"], CASES["d60"][0])
    ranks = {}
    for key, handle in handles.items():
        ranks[key] = _join_ranks(handle)
        for path in handle["workdir"].glob("rank*.pt"):  # float64 gradients of a 4.3M-parameter model
            path.unlink()
    return dict(ranks=ranks, one=one, one_f32=one_f32, cli_one=cli_one, jax=jax, batches=spec["batches"],
                two_dir=tmp / "two", one_dir=tmp / "one")


def _jax_step(flat, batch, maxdisp):
    """The JAX package's train_step (and its train forward's disparities)
    under a (1, 2) mesh with the disparity constraint, in float32, the
    smooth_l1 loss."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from dcanet_tpu.models import DCANet as FlaxDCANet
    from dcanet_tpu.parallel import make_disp_constraint as jconstraint
    from dcanet_tpu.parallel import make_mesh as jmake_mesh
    from dcanet_tpu.train import loop as jloop
    from dcanet_tpu.train import schedule as jsched
    from dcanet_tpu.train.state import TrainState as FlaxTrainState

    mesh = jmake_mesh(n_data=1, n_disp=2)
    model = FlaxDCANet(maxdisp=maxdisp, num_cva=1, constrain_volume=jconstraint(mesh))
    variables = unflatten_dict(flat, sep="/")
    tx = jsched.make_adam(jsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = FlaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    nhwc = {k: jnp.asarray(v.numpy().astype(np.float32).transpose(0, 2, 3, 1)) for k, v in batch.items()
            if k != "disparity"}
    jbatch = dict(nhwc, disparity=jnp.asarray(batch["disparity"].numpy().astype(np.float32)))
    with jax.sharding.set_mesh(mesh):
        out, _ = jax.jit(lambda v, l, r: model.apply(v, l, r, train=True, mutable=["batch_stats"]))(
            variables, nhwc["left"], nhwc["right"])
        _, metrics = jloop.train_step(state, jbatch, jloop.LossConfig(max_disp=maxdisp, preset="smooth_l1"))
    return {k: float(v) for k, v in metrics.items()}, [np.asarray(d) for d in out.disparities]


def _rel_l2(got, want, floor: float = 0.0) -> float:
    return float((got - want).norm()) / max(float(want.norm()), floor)


def _scaled(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


# ---- the batches ----

@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_is_the_presets(runs, case):
    """Halved crops of the dense gt: unknown pixels at 0, and gt at or past
    maxdisp that the mask drops."""
    maxdisp, crop, scenes = CASES[case][:3]
    batch = runs["batches"][case]
    assert batch["left"].shape == (len(scenes), 3, *crop) and batch["disparity"].shape == (len(scenes), *crop)
    disp = batch["disparity"].numpy()
    valid = (disp > 0) & (disp < maxdisp)
    assert 0.3 < valid.mean() < 1.0 and (disp >= maxdisp).any() and (disp == 0).any()


# ---- the grids ----

@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_mesh_places_the_ranks_on_the_grid(runs, grid):
    n_data, n_disp = grid
    assert [r["mesh"] for r in runs["ranks"][grid]] == [(n_data, n_disp, 0, p) for p in range(n_disp)]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_d60_ranks_build_the_cards_plane_ranges(runs, grid):
    """At D = 60 each rank builds the volume of its own planes, the ranges
    that the card's kernels take (chip_smoke.py phase 2); one process the
    whole volume."""
    assert runs["one"]["d60"]["planes"] == [(0, 60)]
    assert [r["steps"]["d60"]["planes"] for r in runs["ranks"][grid]] == [[p] for p in D60_RANGES[grid[1]]]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_one_process_float64(runs, grid, case):
    want = runs["one"][case]
    ranks = [r["steps"][case] for r in runs["ranks"][grid]]
    got = ranks[0]
    digest = _grads_digest(got["grads"])
    for r in ranks[1:]:
        assert r["metrics"] == got["metrics"] and r["grads"] == digest
    assert set(got["metrics"]) == set(want["metrics"]) == set(STEP_KEYS)
    for k in ("total", "smooth_l1", "epe"):
        assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-7, abs=1e-12), k
    # the norm is summed in float32 (train/loop.py::global_norm)
    assert got["metrics"]["grad_norm"] == pytest.approx(want["metrics"]["grad_norm"], rel=1e-6)
    assert set(got["grads"]) == set(want["grads"])
    whole = float(torch.sqrt(sum(g.norm() ** 2 for g in want["grads"].values())))
    errs = {n: _rel_l2(got["grads"][n], g, 1e-6 * whole) for n, g in want["grads"].items()}
    print(f"\n[middlebury {case} {grid}] loss relative {abs(got['metrics']['total'] / want['metrics']['total'] - 1):.2e}, "
          f"worst parameter gradient {max(errs.values()):.3e}")
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-7, (worst, errs[worst])
    for k, v in want["stats"].items():
        assert _scaled(got["stats"][k], v) <= 1e-10, k


def test_sharded_f32_step_matches_one_process(runs):
    got, want = runs["ranks"][(1, 2)][0]["f32"]["metrics"], runs["one_f32"]["metrics"]
    for k in ("total", "smooth_l1"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-3)


@pytest.mark.parametrize("key", STEP_KEYS)
def test_sharded_f32_step_matches_jax(runs, key):
    """The (1, 2) step at D = 60 against the JAX package's under a (1, 2)
    mesh; the grad norm against the float64 gradient's (see the module
    docstring)."""
    got = runs["ranks"][(1, 2)][0]["f32"]["metrics"][key]
    want = runs["jax"][0][key]
    assert np.isfinite(got)
    if key == "epe":
        assert got == pytest.approx(want, abs=2e-2)
    elif key == "grad_norm":
        exact = runs["one"]["d60"]["metrics"]["grad_norm"]
        print(f"\n[middlebury d60 (1, 2) f32] grad norm {got:.6f}, float64 {exact:.6f} ({abs(got - exact) / exact:.2e}); "
              f"JAX f32 {want:.6f} ({abs(want - exact) / exact:.2e})")
        assert got == pytest.approx(exact, rel=1e-3)
    else:
        assert got == pytest.approx(want, rel=1e-4)


def test_sharded_f32_train_disparities_match_jax(runs):
    """The (1, 2) f32 train forward's disparities within 2e-2 px of the JAX
    package's under the (1, 2) mesh, and of one process's float64 ones. (On
    a crop of background alone, 8-11 px of gt, the JAX f32 forward lay 0.05-
    0.06 px from the port's float64 one and the port's f32 1.1e-3 px: the
    JAX package's f32 rounding, not the sharding.)"""
    got = runs["ranks"][(1, 2)][0]["f32"]["disparities"]
    want, wide = runs["jax"][1], runs["one"]["d60"]["disparities"]
    assert len(got) == len(want) == len(wide) == 2
    for g, w, x in zip(got, want, wide):
        print(f"\n[middlebury d60 (1, 2) f32] train disparity from float64: {float((g.double() - x).abs().max()):.2e} "
              f"px, JAX f32 {float((torch.tensor(np.asarray(w)).double() - x).abs().max()):.2e} px")
        np.testing.assert_allclose(g.numpy(), w, atol=2e-2, rtol=0)
        np.testing.assert_allclose(g.double().numpy(), x.numpy(), atol=2e-2, rtol=0)


# ---- cli train ----

def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_train_middlebury_disp_ranks_match_one_process(runs):
    r0, r1 = runs["ranks"]["cli"]
    one = runs["cli_one"]["hist"]
    assert [r["step"] for r in r0["hist"]] == [r["step"] for r in one] == list(range(CLI_SCENES))
    assert [{k: r[k] for k in STEP_KEYS} for r in r0["hist"]] == [{k: r[k] for k in STEP_KEYS} for r in r1["hist"]]
    for got, want in zip(r0["hist"], one):
        for k in STEP_KEYS:
            rel = 1e-6 if k == "grad_norm" else 1e-7
            assert np.isfinite(got[k]) and got[k] == pytest.approx(want[k], rel=rel), (got["step"], k)
    got, want = _rows(runs["two_dir"] / "metrics.jsonl"), _rows(runs["one_dir"] / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(1, CLI_SCENES + 1))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k.startswith("train/"):
                rel = 1e-6 if k == "train/grad_norm" else 1e-7
                assert g[k] == pytest.approx(v, rel=rel), (g["step"], k)


def test_cli_train_middlebury_disp_ranks_build_their_planes(runs):
    """One volume a step: 30 planes on each of the 2 ranks, 60 in one process."""
    r0, r1 = runs["ranks"]["cli"]
    assert runs["cli_one"]["planes"] == [(0, 60)] * CLI_SCENES
    assert (r0["planes"], r1["planes"]) == ([(0, 30)] * CLI_SCENES, [(30, 60)] * CLI_SCENES)


def test_cli_train_middlebury_disp_rank1_writes_no_file(runs):
    r0, r1 = runs["ranks"]["cli"]
    assert r1["written"] == []
    names = {os.path.basename(p) for p in r0["written"]}
    assert {"train_log.jsonl", "metrics.jsonl", f"ckpt_{CLI_SCENES:08d}.pt"} <= names


def test_cli_train_middlebury_disp_replicas_end_equal(runs):
    r0, r1 = runs["ranks"]["cli"]
    assert r0["digest"] == r1["digest"]
