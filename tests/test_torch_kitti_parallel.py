"""The kitti preset's training over data-parallel ranks on the CPU (gloo):
ranks against one process on the same global batch, and against the JAX
package's `train_step`.

The setup: DCANet(num_cva=1, maxdisp=32) from seeded flax variables
(`weights.from_jax_variables`, drawn as in tests/test_torch_train.py), the
`kitti` loss (5x / 10x focal on the sparse gt max-pooled to each volume,
the smooth-L1 ladder on the sparse gt), Adam on `kitti_finetune_schedule`;
a procedural kitti_mix (`write_procedural_kitti_tree`: KITTI 2012 and
KITTI 2015 scenes, the sparse gt of `kitti_sparse_gt`) through the kitti
training transform with the crop cut to 32x64, a global batch of 6 whose
ranks' valid-pixel counts differ.

- The Loader over kitti_mix's two roots: the ranks' batch k, interleaved, is
  the one-process batch k of 6, array for array (the per-sample generator
  makes a sample's augmentation the same on any rank).
- `train_step` over 2 and 3 ranks (3 and 2 pairs each) against one process
  on the whole batch. In float64, two steps: every metric of each step
  within 1e-7 (grad_norm 1e-6: it is summed in float32), every parameter's
  gradient and value within 1e-7 (relative L2; a parameter's gradient
  relative to max(its norm, 1e-6 of the whole)), BatchNorm statistics
  1e-10 scaled by max(|x|, 1). In float32, one step, at
  tests/test_torch_parallel.py's bounds: loss terms rtol 1e-5, grad norm
  rtol 1e-3, BatchNorm statistics 1e-5 scaled, the parameters after Adam's
  step by the firm rule of tests/test_torch_train_step.py. The ranks hold
  the same summed gradient and end with the same parameters, bit for bit.
  The focal terms divide a per-rank mean over all pixels by the process
  count and the smooth-L1 term and EPE divide by the all-reduced valid
  count: float64 tells a wrong formula from rounding.
- The 2-rank step against the JAX package's `train_step` on the global
  batch, at tests/test_torch_kitti_train.py's bounds: the f32 loss terms
  rtol 1e-4, EPE atol 2e-2, BatchNorm statistics 1e-3 scaled; the grad norm
  rtol 1e-3 of the JAX float64 gradient's norm (the JAX f32 step's own norm
  reads 1.5e-3 from the port's at this batch of 6, and its f32 gradient
  sits ~1e-2 from float64: tests/test_torch_kitti_train.py); the 2-rank
  float64 step's gradient against the JAX package's float64 gradient
  (`jax.enable_x64`) within 1e-6 (whole, relative L2) and each parameter
  within 1e-5 of its norm plus 1e-8 of the whole gradient's; the 2-rank
  f32 step's within 1e-4 (whole) and each parameter within 1e-3 of its
  norm plus 1e-6 of the whole's of the float64 step on the f32 step's
  ReLU branches, and within 6e-3 (whole) of the JAX float64 gradient: a
  few activations of this batch lie within f32 rounding of a ReLU's kink
  and take the other branch in float64 (see the test).
- `cli train --preset kitti --model dcanet-cva1 --batch-size 6 --loadckpt`
  over 2 ranks (the group formed from the DCANET_* variables) against one
  process, in
  float64 (the model made in float64, each batch cast to it), one epoch of
  2 steps: every `metrics.jsonl` row and every step's record within 1e-7
  (grad_norm 1e-6), the ranks' records equal, each rank's first step finds
  the export's weights, step 0, no Adam state and lr 1e-3, rank 1 writes no
  file, the replicas bit-equal at the end.

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
import torch.nn.functional as F

from chip_smoke import _grads_digest, first_step_probe, state_digest, writes_under
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.data import datasets as tds
from dcanet_tpu_torch.data import loader as tloader
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.parallel import distributed, make_mesh, shard_batch
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.checkpoint import save_params_only
from dcanet_tpu_torch.train.state import create_train_state
from test_torch_disp_sharding import _join_ranks, _start_ranks
from test_torch_parallel import _steps_in

torch.set_num_threads(2)

MAXDISP, CROP, TREE_HW, BATCH, STEPS_PER_EPOCH = 32, (32, 64), (48, 160), 6, 10
SCENES = 6  # per tree: kitti_mix holds 6 KITTI 2012 + 6 KITTI 2015 scenes, two global batches of 6
# the global batch: three KITTI 2012 crops, then three KITTI 2015 ones
BATCH_INDICES = (0, 1, 2, SCENES, SCENES + 1, SCENES + 2)
WORLDS = (2, 3)
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# float64 takes two steps (Adam's moments carry the first into the second);
# float32 one (its rounding splits the gradient by more than Adam's first,
# sign-like step tolerates: tests/test_torch_parallel.py)
STEPS = {"f32": 1, "f64": 2}
METRICS = ("total", "focal", "smooth_l1", "grad_norm", "epe")
CASES = [(world, tag) for world in WORLDS for tag in DTYPES]


def _loss_cfg():
    return tloop.LossConfig(max_disp=MAXDISP, sparse=True, preset="kitti")


# ---- the ranks ----

def _child(rank, world, cli_port, port, spec_path, out_path):
    """A rank on the CPU, one thread: `cli train` (its group formed by the
    command from the DCANET_* variables), or, in a group formed here, the
    train steps on this rank's share of the global batch."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    spec = torch.load(spec_path, weights_only=False)
    if spec["job"] == "cli":
        os.environ.update(DCANET_COORDINATOR=f"127.0.0.1:{cli_port}", DCANET_NUM_PROCESSES=str(world),
                          DCANET_PROCESS_ID=str(rank))
        result = _cli_train(spec["roots"], spec["weights"], spec["logdir"])
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
        batch = shard_batch(spec["batch"], make_mesh())
        result = {"valid": int(tloop.valid_mask(batch["disparity"], MAXDISP).sum()),
                  "steps": _all_steps(spec["state_dict"], batch)}
        if rank != 0:  # rank 0's gradients and parameters stand for the others'; they send digests
            for res in (v for v in result["steps"].values() if isinstance(v, dict)):
                res["grads"] = [_grads_digest(g) for g in res["grads"]]
                res["state_dict"] = _grads_digest(res["state_dict"])
    distributed.shutdown()
    torch.save(result, out_path)


@contextlib.contextmanager
def relu_branches(masks: list, replay: bool = False):
    """Every ReLU and LeakyReLU call (`torch.relu`, `F.relu`, `F.leaky_relu`)
    in call order: record into `masks` which of its inputs lie above the
    kink at 0, or, with `replay`, take those recorded branches (x where the
    mask holds, slope * x elsewhere) whatever the sign of this call's
    input. Recording leaves the computation as it is."""
    saved = torch.relu, F.relu, F.leaky_relu
    calls = iter(masks)

    def act(fn, x, slope, *args):
        if replay:
            return torch.where(next(calls), x, x * slope)
        masks.append(x.detach() > 0)
        return fn(x, *args)

    torch.relu = lambda x: act(saved[0], x, 0.0)
    F.relu = lambda x, inplace=False: act(saved[1], x, 0.0, inplace)
    F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: act(saved[2], x, negative_slope, negative_slope,
                                                                     inplace)
    try:
        yield masks
    finally:
        torch.relu, F.relu, F.leaky_relu = saved
    assert not replay or next(calls, None) is None, "fewer activations than recorded"


def _steps(state_dict, batch, tag, steps=None, branches=contextlib.nullcontext()) -> dict:
    """`steps` (STEPS[tag]) kitti train steps in DTYPES[tag] from
    `state_dict` on `batch`, the first under `branches`: each step's
    metrics and parameter gradients, the state_dict after the last."""
    dtype = DTYPES[tag]
    model = DCANet(maxdisp=MAXDISP, num_cva=1)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(dtype).train()
    state = create_train_state(model, tsched.kitti_finetune_schedule(STEPS_PER_EPOCH))
    batch = {k: v.to(dtype) for k, v in batch.items()}
    metrics, grads = [], []
    for i in range(steps or STEPS[tag]):
        with branches if i == 0 else contextlib.nullcontext():
            metrics.append({k: float(v) for k, v in tloop.train_step(state, batch, _loss_cfg()).items()})
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    return {"metrics": metrics, "grads": grads, "state_dict": {k: v.clone() for k, v in model.state_dict().items()}}


def _all_steps(state_dict, batch) -> dict:
    """The f32 and float64 steps (`_steps`), and one float64 step on the
    first f32 step's ReLU branches (`f64 branch`); the first step's ReLU
    and LeakyReLU calls (`calls`), their activations (`activations`) and
    those whose branch the f32 and float64 first steps chose differently
    (`flips`)."""
    masks32, masks64 = [], []
    out = {"f32": _steps(state_dict, batch, "f32", branches=relu_branches(masks32)),
           "f64": _steps(state_dict, batch, "f64", branches=relu_branches(masks64)),
           "f64 branch": _steps(state_dict, batch, "f64", 1, relu_branches(masks32, replay=True))}
    assert len(masks32) == len(masks64) > 0
    out["flips"] = sum(int((a != b).sum()) for a, b in zip(masks32, masks64))
    out["calls"], out["activations"] = len(masks32), sum(m.numel() for m in masks32)
    return out


def _train_args(roots, weights, logdir):
    return ["train", "--preset", "kitti", "--data-root", str(roots[0]), "--data-root2", str(roots[1]),
            "--logdir", str(logdir), "--loadckpt", str(weights), "--model", "dcanet-cva1", "--maxdisp", str(MAXDISP),
            "--batch-size", str(BATCH), "--epochs", "1", "--num-workers", "2", "--print-freq", "1", "--seed", "3",
            "--device", "cpu"]


def _cli_train(roots, weights, logdir) -> dict:
    """`cli train --preset kitti` for one epoch in float64 (the crop cut to
    CROP): the records, what the first step found, the paths written under
    `logdir`, the final state's digest."""
    first = []
    with pytest.MonkeyPatch.context() as mp, writes_under(str(logdir), []) as written, \
            _steps_in(torch.float64) as states, first_step_probe(first):
        mp.setitem(tds.PRESETS, "kitti", dict(tds.PRESETS["kitti"], crop=CROP))
        hist = cli.main(_train_args(roots, weights, logdir))
    start = first[0]
    return {"hist": hist, "written": written, "digest": state_digest(states[0]),
            "first": {k: start[k] for k in ("step", "adam_entries", "lr")},
            "first_weights": _grads_digest({k: v.float() for k, v in start["weights"].items()})}


# ---- data ----

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from dcanet_tpu_torch.data.synthetic import write_procedural_kitti_tree

    base = tmp_path_factory.mktemp("kitti_parallel")
    return (write_procedural_kitti_tree(base / "k12", "kitti2012", SCENES, TREE_HW, seed=21, workers=1),
            write_procedural_kitti_tree(base / "k15", "kitti2015", SCENES, TREE_HW, seed=22, workers=1))


def _dataset(roots):
    ds = cli.build_dataset(preset("kitti", data_root=str(roots[0]), data_root2=str(roots[1])), training=True)
    ds.cfg = dict(ds.cfg, crop=CROP)
    return ds


def _global_batch(roots) -> dict:
    """BATCH crops of kitti_mix through the kitti training transform, NCHW."""
    ds = _dataset(roots)
    ds.reseed(1)
    samples = [ds[i] for i in BATCH_INDICES]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("epoch", [0, 1])
def test_loader_ranks_make_the_one_process_batch(trees, world, epoch):
    """kitti_mix over two roots: rank r's batch k holds the one-process batch
    k's samples r, r + world, ...; the same arrays, bit for bit."""
    ds = _dataset(trees)
    one = tloader.Loader(ds, BATCH, seed=3, num_workers=2)
    one.set_epoch(epoch)
    want = list(one)
    ranks = []
    for r in range(world):
        lo = tloader.Loader(ds, BATCH // world, seed=3, num_workers=2, shard=(r, world))
        lo.set_epoch(epoch)
        ranks.append(list(lo))
    assert len(want) == 2 and all(len(b) == len(want) for b in ranks)
    for k, batch in enumerate(want):
        assert set(batch) == {"left", "right", "disparity"}
        for key, v in batch.items():
            got = np.stack([ranks[j % world][k][key][j // world] for j in range(BATCH)])
            np.testing.assert_array_equal(got, v, err_msg=f"batch {k} {key}")


# ---- the ranks and one process ----

@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """Both grids' ranks and `cli train`'s 2 ranks, started at once; meanwhile
    in this process the one-process steps, `cli train` and the JAX step."""
    from test_torch_train import _flat_variables

    tmp = tmp_path_factory.mktemp("kitti_parallel_runs")
    flat = _flat_variables(1, seed=23)
    state_dict = W.from_jax_variables(flat, 1)
    batch = _global_batch(trees)
    model = DCANet(maxdisp=MAXDISP, num_cva=1)
    model.load_state_dict(state_dict, strict=True)
    weights = tmp / "weights.pt"
    save_params_only(weights, model)
    handles = {world: _start_ranks(world, {"job": "steps", "batch": batch, "state_dict": state_dict},
                                   tmp / f"world{world}", "test_torch_kitti_parallel") for world in WORLDS}
    handles["cli"] = _start_ranks(2, {"job": "cli", "roots": trees, "weights": weights, "logdir": tmp / "two"},
                                  tmp / "cli", "test_torch_kitti_parallel")
    one = _all_steps(state_dict, batch)
    cli_one = _cli_train(trees, weights, tmp / "one")
    jax = _jax_step(flat, batch)
    ranks = {}
    for key, handle in handles.items():
        ranks[key] = _join_ranks(handle)
        for path in handle["workdir"].glob("rank*.pt"):  # float64 gradients of a 4.6M-parameter model
            path.unlink()
    return dict(ranks=ranks, one=one, cli_one=cli_one, jax=jax, flat=flat, state_dict=state_dict,
                one_dir=tmp / "one", two_dir=tmp / "two", weights=weights)


def _jax_step(flat, batch):
    """The JAX package's kitti `train_step` on the global batch in f32 (its
    metrics and BatchNorm statistics after it, flat) and the JAX package's
    float64 gradient of the same loss (`jax.enable_x64`)."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from dcanet_tpu.models import DCANet as FlaxDCANet
    from dcanet_tpu.train import loop as jloop
    from dcanet_tpu.train import schedule as jsched
    from dcanet_tpu.train.state import TrainState as FlaxTrainState
    from test_torch_kitti_train import _jax_gradient
    from test_torch_train import _flatten

    nhwc = tuple(np.ascontiguousarray(batch[k].numpy().transpose(0, 2, 3, 1)) for k in ("left", "right"))
    arrays = (*nhwc, batch["disparity"].numpy())
    variables = unflatten_dict(flat, sep="/")
    model = FlaxDCANet(maxdisp=MAXDISP, num_cva=1)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jsched.make_adam(jsched.kitti_finetune_schedule(STEPS_PER_EPOCH))
    state = FlaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    jbatch = dict(zip(("left", "right", "disparity"), (jnp.asarray(a) for a in arrays)))
    new, metrics = jloop.train_step(state, jbatch, jloop.LossConfig(max_disp=MAXDISP, sparse=True, preset="kitti"))
    stats = {f"batch_stats/{k}": np.asarray(v) for k, v in _flatten(new.batch_stats).items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "stats": stats,
            "grad64": _jax_gradient(flat, arrays, wide=True)}


def _rel_l2(got, want, floor: float = 0.0) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm()) / max(float(want.norm()), floor, 1e-30)


def _scaled(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(float(want.double().abs().max()), 1.0)


def test_ranks_valid_counts_differ(runs):
    """The sparse gt leaves each rank its own count of valid pixels, which
    the smooth-L1 term's and EPE's all-reduced denominators must sum."""
    for world in WORLDS:
        counts = [r["valid"] for r in runs["ranks"][world]]
        assert len(set(counts)) == world and min(counts) > 0, counts


@pytest.mark.parametrize("world,tag", CASES)
def test_kitti_step_metrics_match_one_process(runs, world, tag):
    """Every step's metrics: float64 1e-7 (grad_norm 1e-6, summed in
    float32); float32 loss terms 1e-5, grad norm 1e-3. The ranks report the
    same metrics."""
    want = runs["one"][tag]["metrics"]
    ranks = [r["steps"][tag] for r in runs["ranks"][world]]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks[1:])
    got = ranks[0]["metrics"]
    assert len(got) == len(want) == STEPS[tag]
    print(f"\n[kitti {world} ranks {tag}] relative to one process: " + ", ".join(
        f"step {i} {k} {abs(g[k] - w[k]) / abs(w[k]):.2e}" for i, (g, w) in enumerate(zip(got, want))
        for k in METRICS))
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(METRICS)
        for k in METRICS:
            if tag == "f64":
                rel = 1e-6 if k == "grad_norm" else 1e-7
            else:
                rel = 1e-3 if k == "grad_norm" else 1e-5
            assert np.isfinite(g[k]) and g[k] == pytest.approx(w[k], rel=rel), k


@pytest.mark.parametrize("world,tag", CASES)
def test_kitti_step_gradients_match_one_process(runs, world, tag):
    """The ranks hold the same summed gradient, bit for bit, at every step.
    In float64 each parameter's gradient at each step is within 1e-7
    (relative L2) of the one-process gradient, relative to max(its norm,
    1e-6 of the whole gradient's): a conv bias before a BatchNorm has an
    exact gradient of 0. In float32 the whole gradient's distance is
    printed (an f32 step lies ~3e-3 from float64 in one process too: a few
    activations at a ReLU's kink take the other branch; see
    test_two_rank_kitti_gradients_match_jax_float64)."""
    ranks = [r["steps"][tag] for r in runs["ranks"][world]]
    for step, (got, want) in enumerate(zip(ranks[0]["grads"], runs["one"][tag]["grads"])):
        assert all(r["grads"][step] == _grads_digest(got) for r in ranks[1:])
        assert set(got) == set(want)
        whole = float(torch.sqrt(sum(w.double().norm() ** 2 for w in want.values())))
        errs = {n: _rel_l2(got[n], w, 1e-6 * whole) for n, w in want.items()}
        dist_whole = float(torch.sqrt(sum((got[n].double() - w.double()).norm() ** 2 for n, w in want.items()))) / whole
        print(f"\n[kitti {world} ranks {tag}] step {step}: the whole gradient {dist_whole:.3e} from one process's; "
              f"worst parameter {max(errs.values()):.3e}")
        if tag == "f64":
            worst = max(errs, key=errs.get)
            assert errs[worst] <= 1e-7, (worst, errs[worst])


@pytest.mark.parametrize("world,tag", CASES)
def test_kitti_step_bn_statistics_match_one_process(runs, world, tag):
    want = runs["one"][tag]["state_dict"]
    got = runs["ranks"][world][0]["steps"][tag]["state_dict"]
    for k, v in want.items():
        if "running" in k:
            assert _scaled(got[k], v) <= (1e-5 if tag == "f32" else 1e-10), k
        elif "num_batches_tracked" in k:
            assert int(got[k]) == int(v), k


@pytest.mark.parametrize("world,tag", CASES)
def test_kitti_step_parameters_match_one_process(runs, world, tag):
    """The replicas' parameters and buffers are equal bit for bit. float64,
    after two steps: each parameter within 1e-7 (relative L2) of one
    process's. float32, Adam's first step, by the firm rule of
    tests/test_torch_train_step.py: where both steps are within 0.1 % of
    +-lr they agree to 1e-5; the rest stay under 1 % of the elements and no
    step exceeds lr."""
    lr, start = 1e-3, runs["state_dict"]
    ranks = [r["steps"][tag] for r in runs["ranks"][world]]
    got, want = ranks[0]["state_dict"], runs["one"][tag]["state_dict"]
    assert all(r["state_dict"] == _grads_digest(got) for r in ranks[1:])
    loose = total = 0
    for k in runs["one"][tag]["grads"][0]:
        if tag == "f64":
            assert _rel_l2(got[k], want[k]) <= 1e-7, k
            continue
        d_got, d_want = (got[k] - start[k]).numpy(), (want[k] - start[k]).numpy()
        firm = (np.sign(d_got) == np.sign(d_want)) & (np.minimum(np.abs(d_got), np.abs(d_want)) > 0.999 * lr)
        np.testing.assert_allclose(d_got[firm], d_want[firm], atol=1e-5, rtol=0, err_msg=k)
        assert np.abs(d_got).max() <= 1.01 * lr, k
        loose += int((~firm).sum())
        total += d_got.size
    assert loose <= 0.01 * total, (loose, total)


# ---- the 2-rank step against the JAX package ----

@pytest.mark.parametrize("key", METRICS)
def test_two_rank_kitti_step_matches_jax(runs, key):
    """The loss terms and EPE against the JAX f32 step; the grad norm against
    the norm of the JAX package's float64 gradient, as the gradients below
    (the JAX f32 step's own norm, which strays from it, printed beside it),
    as tests/test_torch_middlebury_train.py holds it."""
    got, want = runs["ranks"][2][0]["steps"]["f32"]["metrics"][0][key], runs["jax"]["metrics"][key]
    if key == "epe":
        assert got == pytest.approx(want, abs=2e-2)
    elif key == "grad_norm":
        exact = float(np.sqrt(sum(float((v ** 2).sum()) for v in runs["jax"]["grad64"].values())))
        print(f"\n[kitti 2 ranks f32] grad norm: {got:.6f}, JAX float64 {exact:.6f}, JAX f32 {want:.6f} "
              f"({abs(want - exact) / exact:.2e} from float64)")
        assert got == pytest.approx(exact, rel=1e-3)
    else:
        assert got == pytest.approx(want, rel=1e-4)


def test_two_rank_kitti_bn_statistics_match_jax(runs):
    got = W.to_jax_variables(runs["ranks"][2][0]["steps"]["f32"]["state_dict"], 1)
    want = runs["jax"]["stats"]
    assert len(want) == 176
    for k, v in want.items():
        assert _scaled(torch.tensor(np.asarray(got[k])), torch.tensor(v)) <= 1e-3, k


def _jax_layout(grads, state_dict) -> dict:
    """Parameter gradients named as the JAX package's flat variables, float64."""
    flat = W.to_jax_variables({k: grads[k].double() if k in grads else v for k, v in state_dict.items()}, 1)
    return {k: np.asarray(v, np.float64) for k, v in flat.items() if k.startswith("params/")}


def _from_exact(got, exact, rtol, atol):
    """The whole gradient's distance from `exact` (relative L2) and the
    largest per-parameter distance over its margin rtol |g| + atol |whole|."""
    keys = sorted(exact)
    assert set(got) == set(exact) and len(keys) == 280
    norm = np.linalg.norm
    whole = norm(np.concatenate([exact[k].ravel() for k in keys]))
    dist_whole = norm(np.concatenate([(got[k] - exact[k]).ravel() for k in keys])) / whole
    return dist_whole, max(norm(got[k] - exact[k]) / (rtol * norm(exact[k]) + atol * whole) for k in keys)


def test_two_rank_kitti_gradients_match_jax_float64(runs):
    """The 2-rank first step's summed gradient against float64, at
    tests/test_torch_kitti_train.py's bounds. float64: within 1e-6 of the
    JAX package's float64 gradient of the same loss on the global batch
    (whole, relative L2), each parameter within 1e-5 of its norm plus 1e-8
    of the whole's. float32: within 1e-4 (whole) of the 2-rank float64
    gradient taken on the f32 step's ReLU and LeakyReLU branches
    (`relu_branches`), each parameter within 1e-3 of its norm plus 1e-6 of
    the whole's; and within 6e-3 (whole) of the JAX float64 gradient, which
    takes its own branches (it read 2.8e-3 on 2 ranks, 3.2e-3 in one
    process). At this batch of 6 a few of the step's activations (printed)
    lie within f32 rounding of a kink at 0, and f32 and float64 take
    different branches there: each such activation moves the gradient by
    its whole share, ~3e-3 in all. On the same branches the f32 step lies
    ~1.4e-5 from float64, as at tests/test_torch_kitti_train.py's batch of
    2, where no activation flips."""
    exact, sd = runs["jax"]["grad64"], runs["state_dict"]
    ranks = runs["ranks"][2]
    wide, wide_worst = _from_exact(_jax_layout(ranks[0]["steps"]["f64"]["grads"][0], sd), exact, 1e-5, 1e-8)
    f32 = _jax_layout(ranks[0]["steps"]["f32"]["grads"][0], sd)
    branch = _jax_layout(ranks[0]["steps"]["f64 branch"]["grads"][0], sd)
    on_branch, on_branch_worst = _from_exact(f32, branch, 1e-3, 1e-6)
    free, _ = _from_exact(f32, exact, 1e-3, 1e-6)
    one, _ = _from_exact(_jax_layout(runs["one"]["f32"]["grads"][0], sd), exact, 1e-3, 1e-6)
    print(f"\n[kitti 2 ranks] the first step's gradient: float64 {wide:.3e} from JAX's float64 (per parameter over its "
          f"margin at most {wide_worst:.4f}); f32 {on_branch:.3e} from float64 on its branches ({on_branch_worst:.4f}), "
          f"{free:.3e} from JAX's float64 (one process's f32 {one:.3e}); activations on the other branch per rank "
          f"{[r['steps']['flips'] for r in ranks]} of {[r['steps']['activations'] for r in ranks]} in "
          f"{ranks[0]['steps']['calls']} calls (one process {runs['one']['flips']} of {runs['one']['activations']})")
    assert wide < 1e-6 and wide_worst <= 1.0
    assert on_branch < 1e-4 and on_branch_worst <= 1.0
    assert free < 6e-3


# ---- cli train over 2 ranks ----

def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_kitti_two_ranks_match_one_process(runs):
    """Every step's record and every metrics.jsonl row within 1e-7
    (grad_norm 1e-6); the ranks' records equal."""
    r0, r1 = runs["ranks"]["cli"]
    one = runs["cli_one"]["hist"]
    assert [r["step"] for r in r0["hist"]] == [r["step"] for r in one] == [0, 1]
    assert [{k: r[k] for k in METRICS} for r in r0["hist"]] == [{k: r[k] for k in METRICS} for r in r1["hist"]]
    for got, want in zip(r0["hist"], one):
        for k in METRICS:
            rel = 1e-6 if k == "grad_norm" else 1e-7
            assert np.isfinite(got[k]) and got[k] == pytest.approx(want[k], rel=rel), (got["step"], k)
    got, want = _rows(runs["two_dir"] / "metrics.jsonl"), _rows(runs["one_dir"] / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert {f"train/{k}" for k in METRICS} <= set(got[0])
    for g, w in zip(got, want):
        for k, v in w.items():
            if k.startswith("train/"):
                rel = 1e-6 if k == "train/grad_norm" else 1e-7
                assert g[k] == pytest.approx(v, rel=rel), (g["step"], k)


def test_cli_kitti_every_rank_starts_from_the_export(runs):
    """--loadckpt on each rank: the first step finds the export's weights,
    step 0, no Adam state and the preset's lr 1e-3."""
    sd = torch.load(runs["weights"], weights_only=True)["state_dict"]
    want = _grads_digest({k: v.double().float() for k, v in sd.items()})
    for res in [*runs["ranks"]["cli"], runs["cli_one"]]:
        assert res["first"] == {"step": 0, "adam_entries": 0, "lr": pytest.approx(1e-3)}
        assert res["first_weights"] == want


def test_cli_kitti_rank1_writes_no_file(runs):
    r0, r1 = runs["ranks"]["cli"]
    assert r1["written"] == []
    assert {"train_log.jsonl", "metrics.jsonl"} <= {os.path.basename(p) for p in r0["written"]}


def test_cli_kitti_replicas_end_equal(runs):
    r0, r1 = runs["ranks"]["cli"]
    assert r0["digest"] == r1["digest"]
