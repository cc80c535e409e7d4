"""Disparity-sharded training of the port (`cli train --n-disp-shards`,
parallel/sharding.py in train mode) on the CPU: ranks under gloo on (data,
disp) grids against one process, and against the JAX package.

- one train step of DCANet (num_cva 0, 1 and 2; num_cva 2 with `remat`;
  num_cva 1 with `full_res_supervision`), maxdisp 32, seeded weights, on a
  global batch of 2 pairs at 32x64 whose valid-pixel counts differ, on the
  grids (1, 2), (1, 3) (half planes 2, 1, 1: uneven, with a middle rank)
  and (2, 2) (4 processes, a disp subgroup per data row), in float64
  against one process on the whole batch: loss terms within 1e-7
  relative, every parameter's gradient within 1e-7 relative in L2 (to
  max(its norm, 1e-6 of the whole)), BatchNorm running statistics within
  1e-10 scaled by max(|x|, 1); the ranks' summed gradients bit-equal;
- the (1, 2) step in float32 against the JAX package's `train_step` under a
  (1, 2) mesh with `constrain_volume=make_disp_constraint(mesh)` on the
  conftest's 8 virtual CPU devices, from the same flat variables: loss
  terms rtol 1e-4, grad norm rtol 1e-3, the train forward's disparities
  within 2e-2 px (tests/test_torch_train_step.py's tolerances);
- `DispShard.halo` (zero and edge fills) and `gather` on every grid: the
  gradient autograd gives each rank against central differences of the
  ranks' summed objective (float64; the exchanges are linear, so the
  differences are exact to rounding);
- `replicate` on a disp row: rank 0's weights on every rank;
- `cli train --n-disp-shards 2` over 2 ranks (the group formed from the
  DCANET_* variables) against one process, on a tiny synthetic SceneFlow
  tree (the crop cut to 32x64), float64 (f32 rounding grows through Adam),
  1 epoch of 2 steps and a resumed one: the same train_log.jsonl rows
  within 1e-7 relative, the ranks' records equal, rank 1 writing no file,
  the replicas bit-equal at the end;
- the plain range backward of the gwc and the concat volume against
  autograd through the whole volume.

The ranks are children of `tests/test_torch_disp_sharding.py`'s harness,
each joined within its CHILD_TIMEOUT_S and killed after it, so that a
deadlock fails. This module imports no JAX at its top, because the
children import it.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import _grads_digest, state_digest, writes_under
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.kernels import gwc as G
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.ops.cost_volume import build_concat_volume
from dcanet_tpu_torch.parallel import distributed, make_disp_constraint, make_mesh, replicate, shard_batch
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.state import create_train_state
from test_torch_disp_sharding import _join_ranks, _start_ranks
from test_torch_parallel import _steps_in

torch.set_num_threads(2)

MAXDISP, H, Wd = 32, 32, 64
LR_SPEC, STEPS_PER_EPOCH = "12,20,24,28:2", 10
GRIDS = ((1, 2), (1, 3), (2, 2))  # (n_data, n_disp)
CASES = {  # name: (num_cva, DCANet keywords)
    "cva0": (0, {}),
    "cva1": (1, {}),
    "cva2": (2, {}),
    "cva2_remat": (2, {"remat": True}),
    "cva1_full_res": (1, {"full_res_supervision": True}),
}
EXCHANGES = ("halo_1_1", "halo_1_0", "halo_0_1", "halo_1_1_edge", "gather")
STEP_KEYS = ("total", "smooth_l1", "grad_norm", "epe")
CLI_KEYS = ("total", "epe")


# ---- the ranks ----

def _child(rank, world, cli_port, port, spec_path, out_path):
    """A rank on the CPU, one thread: `cli train` (its group formed by the
    command from the DCANET_* variables), or, in a group formed here, the
    exchanges' gradients, `replicate` and the train steps."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    spec = torch.load(spec_path, weights_only=False)
    if spec["job"] == "cli":
        os.environ.update(DCANET_COORDINATOR=f"127.0.0.1:{cli_port}", DCANET_NUM_PROCESSES=str(world),
                          DCANET_PROCESS_ID=str(rank))
        result = _cli_train(spec["root"], spec["logdir"], "--n-disp-shards", "2")
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
        mesh = make_mesh(spec["n_data"], world // spec["n_data"])
        result = {"mesh": (mesh.n_data, mesh.n_disp, mesh.rank, mesh.disp_rank),
                  "exchanges": _exchange_grads(mesh), "replicate": _replicate_digest(mesh),
                  "steps": {case: _step(spec, case, torch.float64, mesh) for case in CASES}}
        if spec["f32"]:
            result["f32"] = _step(spec, "cva1", torch.float32, mesh)
        for res in [*result["steps"].values(), result.get("f32")]:  # rank 0's gradients stand for the others'
            if res is not None and rank != 0:
                res["grads"] = _grads_digest(res["grads"])
    distributed.shutdown()
    torch.save(result, out_path)


def _batch() -> dict:
    """A global batch of 2 pairs: pair 0's gt all inside (0, MAXDISP), about
    a third of pair 1's at or above it, so that the valid counts differ."""
    rng = np.random.default_rng(11)
    disp = np.stack([rng.uniform(1.0, MAXDISP - 2.0, (H, Wd)), rng.uniform(1.0, 1.5 * MAXDISP, (H, Wd))])
    return {"left": torch.from_numpy(rng.standard_normal((2, 3, H, Wd))),
            "right": torch.from_numpy(rng.standard_normal((2, 3, H, Wd))),
            "disparity": torch.from_numpy(disp)}


def _step(spec, case, dtype, mesh=None) -> dict:
    """One train step of CASES[case] in `dtype` from the spec's weights, on
    this rank's rows of the global batch with the plan of `mesh`'s disp
    axis (one process: the whole batch, no plan): the metrics, the summed
    gradients, the BatchNorm statistics and the train forward's
    disparities."""
    num_cva, kw = CASES[case]
    plan = None if mesh is None else make_disp_constraint(mesh)
    model = DCANet(maxdisp=MAXDISP, num_cva=num_cva, constrain_volume=plan, **kw)
    model.load_state_dict(spec["states"][num_cva], strict=True)
    model = model.to(dtype).train()
    batch = spec["batch"] if mesh is None else shard_batch(spec["batch"], mesh)
    outs = []
    model.register_forward_hook(lambda m, i, out: outs.append(out))
    state = create_train_state(model, tsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    metrics = tloop.train_step(state, {k: v.to(dtype) for k, v in batch.items()}, tloop.LossConfig(max_disp=MAXDISP))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            "stats": {k: v.clone() for k, v in model.state_dict().items() if "running" in k},
            "disparities": [d.detach().clone() for d in outs[0].disparities]}


def _exchange_grads(mesh) -> dict:
    """Per exchange of this rank's shard of a volume of 8 planes: the
    gradient autograd gives this rank's slab for the objective summed over
    the ranks, sum_r <w_r, f(x_r)>, and its central differences: for each
    rank p and element i in turn, every rank evaluates the summed objective
    with rank p's element i moved by +-eps (the same collectives on every
    rank, in the same order)."""
    shard = make_disp_constraint(mesh).split(8)
    me = distributed.process_index()
    sizes = [2 * c for c in shard.counts]  # each disp rank's planes
    gen = torch.Generator().manual_seed(100 + me)
    x = torch.randn(1, 1, sizes[shard.rank], 1, 2, dtype=torch.float64, generator=gen)
    fns = {
        "halo_1_1": lambda t: shard.halo(t, 1, 1), "halo_1_0": lambda t: shard.halo(t, 1, 0),
        "halo_0_1": lambda t: shard.halo(t, 0, 1), "halo_1_1_edge": lambda t: shard.halo(t, 1, 1, fill="edge"),
        "gather": lambda t: shard.gather(t, 2),
    }
    out, eps = {}, 0.5
    for name, f in fns.items():
        w = torch.randn(f(x.detach()).shape, dtype=torch.float64, generator=gen)

        def total(t):
            s = (f(t) * w).sum().reshape(1)
            dist.all_reduce(s)
            return float(s)

        xg = x.clone().requires_grad_()
        (f(xg) * w).sum().backward()
        fd = torch.zeros_like(x)
        for p in range(distributed.process_count()):
            for i in range(2 * sizes[p % mesh.n_disp]):
                moved = []
                for sign in (1.0, -1.0):
                    t = x.clone()
                    if p == me:
                        t.view(-1)[i] += sign * eps
                    moved.append(total(t))
                if p == me:
                    fd.view(-1)[i] = (moved[0] - moved[1]) / (2 * eps)
        out[name] = (xg.grad, fd)
    return out


def _replicate_digest(mesh) -> str:
    """A module drawn from a seed of this rank's own, after `replicate`."""
    module = torch.nn.Linear(3, 4)
    torch.nn.init.normal_(module.weight, generator=torch.Generator().manual_seed(distributed.process_index()))
    replicate(module, mesh)
    return _grads_digest(module.state_dict())


# ---- cli train ----

def _train_args(root, logdir, *extra):
    return ["train", "--preset", "sceneflow", "--data-root", str(root), "--logdir", str(logdir),
            "--maxdisp", str(MAXDISP), "--batch-size", "2", "--num-workers", "2", "--print-freq", "1",
            "--seed", "3", "--device", "cpu", *extra]


def _cli_train(root, logdir, *extra):
    """`cli train` 1 epoch (2 steps) and a resumed one in float64: the
    records, the paths written under `logdir`, the final state's digest."""
    from dcanet_tpu_torch.data import datasets

    with pytest.MonkeyPatch.context() as mp, writes_under(str(logdir), []) as written, \
            _steps_in(torch.float64) as states:
        mp.setitem(datasets.PRESETS, "sceneflow", dict(datasets.PRESETS["sceneflow"], crop=(H, Wd)))
        hist = cli.main(_train_args(root, logdir, "--epochs", "1", *extra)) + cli.main(
            _train_args(root, logdir, "--epochs", "2", "--resume", *extra))
    return {"hist": hist, "written": written, "digest": state_digest(states[0])}


# ---- one process, and the ranks ----

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every grid's ranks and `cli train`'s 2 ranks, started at once;
    meanwhile in this process the one-process steps and `cli train` and
    the JAX step."""
    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree

    tmp = tmp_path_factory.mktemp("disp_train")
    states = {n: reference_init_(DCANet(maxdisp=MAXDISP, num_cva=n), torch.Generator().manual_seed(20 + n))
              .state_dict() for n in (0, 1, 2)}
    spec = {"job": "steps", "states": states, "batch": _batch()}
    root = write_sceneflow_tree(tmp / "sceneflow", 4, (48, 96), seed=1, max_disp=24)
    handles = {grid: _start_ranks(grid[0] * grid[1], dict(spec, n_data=grid[0], f32=grid == (1, 2)),
                                  tmp / f"grid{grid[0]}x{grid[1]}", "test_torch_disp_train")
               for grid in GRIDS}
    handles["cli"] = _start_ranks(2, {"job": "cli", "root": root, "logdir": tmp / "two"}, tmp / "cli",
                                  "test_torch_disp_train")

    one = {case: _step(spec, case, torch.float64) for case in CASES}
    one_f32 = _step(spec, "cva1", torch.float32)
    cli_one = _cli_train(root, tmp / "one")
    jax_metrics, jax_disps = _jax_step(W.to_jax_variables(states[1], 1), spec["batch"])
    ranks = {}
    for key, handle in handles.items():
        ranks[key] = _join_ranks(handle)
        for path in handle["workdir"].glob("rank*.pt"):  # float64 gradients of a 4.6M-parameter model
            path.unlink()
    return dict(ranks=ranks, one=one, one_f32=one_f32, cli_one=cli_one, jax=(jax_metrics, jax_disps),
                two_dir=tmp / "two", one_dir=tmp / "one")


def _jax_step(flat, batch):
    """The JAX package's train_step (and its train forward's disparities)
    under a (1, 2) mesh with the disparity constraint, in float32."""
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
    model = FlaxDCANet(maxdisp=MAXDISP, num_cva=1, constrain_volume=jconstraint(mesh))
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
        _, metrics = jloop.train_step(state, jbatch, jloop.LossConfig(max_disp=MAXDISP))
    return {k: float(v) for k, v in metrics.items()}, [np.asarray(d) for d in out.disparities]


def _rel_l2(got, want, floor: float = 0.0) -> float:
    return float((got - want).norm()) / max(float(want.norm()), floor)


def _scaled(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


# ---- the grids ----

@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_mesh_places_the_ranks_on_the_grid(runs, grid):
    n_data, n_disp = grid
    assert [r["mesh"] for r in runs["ranks"][grid]] == [
        (n_data, n_disp, p // n_disp, p % n_disp) for p in range(n_data * n_disp)]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_exchange_gradient_matches_finite_differences(runs, grid, exchange):
    """A halo plane's gradient reaches the rank that sent it; a gathered
    axis's is this rank's slice of the ranks' gradients' sum."""
    for rank in runs["ranks"][grid]:
        got, fd = rank["exchanges"][exchange]
        torch.testing.assert_close(got, fd, atol=1e-12, rtol=0)
        assert got.abs().sum() > 0


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_replicate_makes_every_rank_of_the_grid_equal(runs, grid):
    assert len({r["replicate"] for r in runs["ranks"][grid]}) == 1


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_one_process_float64(runs, grid, case):
    want = runs["one"][case]
    ranks = [r["steps"][case] for r in runs["ranks"][grid]]
    got = ranks[0]
    digest = _grads_digest(got["grads"])
    for r in ranks[1:]:
        assert r["metrics"] == got["metrics"] and r["grads"] == digest
    for k in ("total", "smooth_l1", "epe") + (("focal",) if "focal" in want["metrics"] else ()):
        assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-7, abs=1e-12), k
    # the norm is summed in float32 (train/loop.py::global_norm)
    assert got["metrics"]["grad_norm"] == pytest.approx(want["metrics"]["grad_norm"], rel=1e-6)
    assert set(got["grads"]) == set(want["grads"])
    whole = float(torch.sqrt(sum(g.norm() ** 2 for g in want["grads"].values())))
    for n, g in want["grads"].items():
        assert _rel_l2(got["grads"][n], g, 1e-6 * whole) <= 1e-7, n
    for k, v in want["stats"].items():
        assert _scaled(got["stats"][k], v) <= 1e-10, k


@pytest.mark.parametrize("key", ["total", "focal", "smooth_l1", "grad_norm", "epe"])
def test_sharded_f32_step_matches_jax(runs, key):
    got = runs["ranks"][(1, 2)][0]["f32"]["metrics"][key]
    want = runs["jax"][0][key]
    assert np.isfinite(got)
    if key == "epe":
        assert got == pytest.approx(want, abs=2e-2)
    else:
        assert got == pytest.approx(want, rel=1e-3 if key == "grad_norm" else 1e-4)


def test_sharded_f32_train_disparities_match_jax(runs):
    got = runs["ranks"][(1, 2)][0]["f32"]["disparities"]
    want = runs["jax"][1]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-2, rtol=0)


def test_sharded_f32_step_matches_one_process(runs):
    got, want = runs["ranks"][(1, 2)][0]["f32"]["metrics"], runs["one_f32"]["metrics"]
    for k in ("total", "focal", "smooth_l1"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-3)


# ---- cli train ----

def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_train_disp_ranks_match_one_process(runs):
    r0, r1 = runs["ranks"]["cli"]
    one = runs["cli_one"]["hist"]
    assert [r["step"] for r in r0["hist"]] == [r["step"] for r in one] == [0, 1, 2, 3]
    assert [{k: r[k] for k in STEP_KEYS} for r in r0["hist"]] == [{k: r[k] for k in STEP_KEYS} for r in r1["hist"]]
    got, want = _rows(runs["two_dir"] / "train_log.jsonl"), _rows(runs["one_dir"] / "train_log.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] and len(got) == 4
    for g, w in zip(got, want):
        for k in CLI_KEYS:
            assert np.isfinite(g[k]) and g[k] == pytest.approx(w[k], rel=1e-7), (g["step"], k)


def test_cli_train_disp_rank1_writes_no_file(runs):
    r0, r1 = runs["ranks"]["cli"]
    assert r1["written"] == []
    names = {os.path.basename(p) for p in r0["written"]}
    assert {"train_log.jsonl", "metrics.jsonl", "ckpt_00000002.pt", "ckpt_00000004.pt"} <= names


def test_cli_train_disp_replicas_end_equal(runs):
    r0, r1 = runs["ranks"]["cli"]
    assert r0["digest"] == r1["digest"]


# ---- the plain range backward ----

def _volume_backward(volume, grad, left, right, maxdisp, planes=None):
    """Autograd of a plain volume (or of its planes) given `grad`: (dL, dR)."""
    if volume == "gwc":
        return G.gwc_volume_backward_reference(grad, left, right, maxdisp, 4, planes)
    l, r = left.clone().requires_grad_(), right.clone().requires_grad_()
    return torch.autograd.grad(build_concat_volume(l, r, maxdisp, planes), (l, r), grad)


@pytest.mark.parametrize("volume", ["gwc", "concat"])
def test_plain_range_backward_is_the_whole_backward_sliced(volume):
    """Autograd through the plain gwc (the range backward's plain version) or
    concat volume's planes [lo, hi) is autograd through the whole volume
    with the grad zero outside them, and the ranges of the ranks sum to the
    whole backward (W = 12 > D = 8; the last range reaches no column past W)."""
    rng = np.random.default_rng(2)
    left, right = (torch.from_numpy(rng.standard_normal((2, 16, 3, 12))) for _ in range(2))
    maxdisp, channels = 8, 4 if volume == "gwc" else 32
    grad = torch.from_numpy(rng.standard_normal((2, channels, maxdisp, 3, 12)))
    whole = _volume_backward(volume, grad, left, right, maxdisp)
    parts = []
    for lo, hi in ((0, 2), (2, 6), (6, 8)):
        masked = torch.zeros_like(grad)
        masked[:, :, lo:hi] = grad[:, :, lo:hi]
        want = _volume_backward(volume, masked, left, right, maxdisp)
        got = _volume_backward(volume, grad[:, :, lo:hi].contiguous(), left, right, maxdisp, (lo, hi))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-12, rtol=0)
        parts.append(got)
    for i in range(2):
        torch.testing.assert_close(sum(p[i] for p in parts), whole[i], atol=1e-12, rtol=0)
