"""Data-parallel training of the port (dcanet_tpu_torch.parallel) on the CPU:
two processes under gloo against one process on the same global batch.

- `shard_for_host` against dcanet_tpu.data.loader.shard_for_host, exactly;
  the Loader's per-rank length and global batches against the one-process
  Loader's, and one process's batches as the epoch's permutation;
- `initialize` leaves alone what it must (no variables, one process, a
  group already formed) and refuses a partial environment;
  `all_reduce_sum`'s gradient is summed too;
- train-mode BatchNorm2d/3d over 2 ranks whose shards have different means,
  against one process on the whole batch: output, input gradient,
  weight/bias gradients and running statistics within 1e-5 (float32 sums
  in another order), the one-value-per-channel case included; and against
  float64 where channel means are 30x their spread (10x the largest ratio
  of a DCANet train step, chip_smoke.py phase 10), where E[x^2] - E[x]^2 in
  float32 would miss the running variance's bound;
- `train_step` over 2 ranks against one process on the same global batch
  of 2 (the ranks' valid-pixel counts differ; `sceneflow`, `smooth_l1`,
  `sceneflow` with remat). In float64, two steps: every metric within 1e-7,
  every parameter's gradient and value within 1e-7 (relative L2),
  BatchNorm statistics 1e-10 scaled. In float32, one step: loss terms rtol
  1e-5, grad norm rtol 1e-3, BatchNorm statistics 1e-5 scaled, parameters
  after Adam by the firm rule of tests/test_torch_train_step.py. Float32
  rounding alone puts a step's gradient ~3e-3 (relative L2) from the
  float64 one, one process and 2 ranks alike (chip_smoke.py phase 10), so
  the gradients are decided in float64. The 2-rank float32
  step against the JAX `train_step` on the global batch, at that file's
  tolerances;
- `cli train` over 2 ranks (started from the DCANET_* variables) against
  one process at the same --batch-size 2 on a tiny synthetic SceneFlow
  tree, 2 steps and a resumed epoch: in float32 the first step's loss terms
  rtol 1e-5, the ranks' records equal, the same metrics.jsonl rows, rank 1
  writes no file, the replicas end bit-equal; in float64 (the model made in
  float64, each batch cast to it) the same, and every step's metrics
  within 1e-7; the command's errors.

The ranks are child processes (`_child`), each joined within
CHILD_TIMEOUT_S and killed after it; a child's traceback fails the test.
This module imports no JAX at its top, because the children import it.
"""

import contextlib
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import state_digest, writes_under
from dcanet_tpu_torch import cli
from dcanet_tpu_torch.config import RunConfig
from dcanet_tpu_torch.data import loader as tloader
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.nn.layers import batch_norm
from dcanet_tpu_torch.parallel import Mesh, distributed, initialize, make_mesh, shard_batch
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CHILD_TIMEOUT_S = 120
WORLD = 2
MAXDISP, H, Wd = 32, 32, 64
LR_SPEC, STEPS_PER_EPOCH = "12,20,24,28:2", 10
ENV_VARS = ("DCANET_COORDINATOR", "DCANET_NUM_PROCESSES", "DCANET_PROCESS_ID")

BN_CASES = {  # name: NC... shape of the global batch, split over 2 ranks
    "2d": (4, 5, 3, 4),
    "3d": (2, 4, 2, 3, 5),
    "2d_one_per_channel": (2, 3, 1, 1),  # one value per channel on each rank
}
# channel means 30x their spread, held against float64: 10x the largest
# |mean| / std of a BatchNorm input in a full-width DCANet train step
# (chip_smoke.py phase 10)
BN_OFFSET_SHAPE, BN_OFFSET_RATIO = (2, 16, 48, 96), 30.0
STEP_CASES = {  # name: (loss preset, remat)
    "sceneflow": ("sceneflow", False),
    "smooth_l1": ("smooth_l1", False),
    "sceneflow_remat": ("sceneflow", True),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# float64 takes two steps: Adam's moments carry the ranks' first step into
# the second. float32 takes one: two float32 roundings of this step split
# its gradient by more than 1e-4, which Adam's sign-like first steps
# amplify, so float64 decides the gradients.
STEPS = {torch.float32: 1, torch.float64: 2}
# every case in float32; both loss presets and remat in float64
STEP_IDS = [(case, "f32") for case in sorted(STEP_CASES)] + [("smooth_l1", "f64"), ("sceneflow_remat", "f64")]


# ---- the ranks ----

_CHILD = "import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_parallel as t; t._child(*sys.argv[3:])"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(job: str, spec: dict, workdir) -> dict:
    """Start `_child(job, ...)` as WORLD processes; `_join_ranks` waits."""
    workdir.mkdir(parents=True, exist_ok=True)
    spec_path = workdir / f"{job}_spec.pt"
    torch.save(spec, spec_path)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(WORLD):
        with open(workdir / f"{job}_rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, TESTS, REPO, job, str(rank), str(WORLD), str(port), str(spec_path),
                 str(workdir / f"{job}_rank{rank}.pt")],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            ))
    return {"job": job, "procs": procs, "workdir": workdir, "deadline": time.monotonic() + CHILD_TIMEOUT_S}


def _join_ranks(handle: dict) -> list:
    """Wait for the ranks until CHILD_TIMEOUT_S after their start, kill any
    left; their results, by rank, or a failure with each failed rank's log."""
    job, procs, workdir = handle["job"], handle["procs"], handle["workdir"]
    try:
        for p in procs:
            p.wait(timeout=max(handle["deadline"] - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        text = (workdir / f"{job}_rank{rank}.log").read_text()
        assert p.returncode == 0, f"rank {rank} of {job!r} exited {p.returncode}:\n{text[-6000:]}"
    return [torch.load(workdir / f"{job}_rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _child(job, rank, world, port, spec_path, out_path):
    """A rank: gloo on the CPU, one thread; runs `job`, saves its result."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    spec = torch.load(spec_path, weights_only=False)
    if job == "steps":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
        result = _steps_job(spec)
    else:  # "cli": the group is formed by initialize() from the variables
        os.environ.update(DCANET_COORDINATOR=f"127.0.0.1:{port}", DCANET_NUM_PROCESSES=str(world),
                          DCANET_PROCESS_ID=str(rank))
        result = _cli_job(spec)
    distributed.shutdown()
    torch.save(result, out_path)


# ---- one process, and each rank ----

def _bn(params):
    x = params["x"]
    bn = batch_norm(x.shape[1], x.dim() - 2).to(x.dtype)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(params[k])
    return bn.train()


def _bn_run(params, x, g):
    """y, dx, dweight, dbias and the running statistics of one BN train call."""
    bn = _bn(params)
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * g).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def _step_run(spec, case, batch, dtype=torch.float32):
    """STEPS[dtype] train_steps from the spec's weights on `batch`, in
    `dtype`: the last step's metrics and parameter gradients, the
    state_dict after it."""
    preset, remat = STEP_CASES[case]
    model = DCANet(maxdisp=MAXDISP, num_cva=1, remat=remat)
    model.load_state_dict(spec["state_dict"], strict=True)
    model = model.to(dtype)
    batch = {k: v.to(dtype) for k, v in batch.items()}
    state = create_train_state(model.train(), tsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    for _ in range(STEPS[dtype]):
        metrics = tloop.train_step(state, batch, tloop.LossConfig(max_disp=MAXDISP, preset=preset))
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
        "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
    }


def _steps_job(spec):
    """BatchNorm cases and train steps on this rank's shard; initialize()
    once the group is up, with variables that would form another."""
    mesh = make_mesh()
    out = {"bn": {}, "steps": {}}
    for case, params in spec["bn"].items():
        shard = shard_batch({"x": params["x"], "g": params["g"]}, mesh)
        out["bn"][case] = _bn_run(params, shard["x"], shard["g"])
    batch = shard_batch(spec["batch"], mesh)
    for case in STEP_CASES:
        for tag, dtype in DTYPES.items():
            if (case, tag) in STEP_IDS:
                out["steps"][case, tag] = _step_run(spec, case, batch, dtype)
    rank = mesh.rank + 1.0
    t = torch.tensor([1.0, 2.0], requires_grad=True)
    summed = distributed.all_reduce_sum(t * rank)
    (summed * rank).sum().backward()
    out["all_reduce_sum"] = (summed.detach(), t.grad)
    os.environ.update(DCANET_COORDINATOR="127.0.0.1:1", DCANET_NUM_PROCESSES="3", DCANET_PROCESS_ID="0")
    out["initialize_when_up"] = (str(initialize(device="cpu")), distributed.process_count())
    return out


def _train_args(root, logdir, *extra):
    return ["train", "--preset", "sceneflow", "--data-root", str(root), "--logdir", str(logdir),
            "--maxdisp", "32", "--batch-size", "2", "--num-workers", "2", "--print-freq", "1", "--seed", "3",
            "--device", "cpu", *extra]


@contextlib.contextmanager
def _steps_in(dtype):
    """`cli train`'s steps in `dtype`: the model and its optimizer state are
    made in it (the default dtype) and each batch is cast to it; yields a
    list that holds the newest step's state."""
    states, real_step = [], tloop.train_step

    def step(state, batch, cfg):
        states[:] = [state]
        return real_step(state, {k: v.to(dtype) for k, v in batch.items()}, cfg)

    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    tloop.train_step = step
    try:
        yield states
    finally:
        tloop.train_step = real_step
        torch.set_default_dtype(prev)


def _cli_train(root, logdir, dtype):
    """`cli train` 1 epoch (2 steps) and a resumed one in `dtype`: the
    records, the paths written under `logdir`, the final state's digest."""
    with writes_under(str(logdir), []) as written, _steps_in(dtype) as states:
        hist = cli.main(_train_args(root, logdir, "--epochs", "1")) + cli.main(
            _train_args(root, logdir, "--epochs", "2", "--resume"))
    return {"hist": hist, "written": written, "digest": state_digest(states[0])}


def _cli_job(spec):
    """The command's errors, then `cli train` in float32 and in float64."""
    from dcanet_tpu_torch.data import datasets

    datasets.PRESETS["sceneflow"] = dict(datasets.PRESETS["sceneflow"], crop=(32, 64))
    root, logdir = spec["root"], spec["logdir"]
    errors = {}
    for name, extra in (("batch_3", ["--batch-size", "3"]), ("n_data_1", ["--n-data-shards", "1"])):
        try:
            cli.main(_train_args(root, logdir, *extra, "--epochs", "1"))
        except ValueError as e:
            errors[name] = str(e)
    return {"errors": errors, **{tag: _cli_train(root, f"{logdir}_{tag}", DTYPES[tag]) for tag in DTYPES}}


# ---- data ----

@pytest.mark.parametrize("n,count,seed,shuffle", [
    (10, 1, 0, True), (10, 2, 0, True), (11, 2, 1, True), (11, 3, 2, True), (7, 4, 3, True), (3, 4, 5, True),
    (9, 2, 0, False), (10, 3, 7, False),
])
def test_shard_for_host_matches_jax(n, count, seed, shuffle):
    from dcanet_tpu.data.loader import shard_for_host as jshard

    shards = []
    for rank in range(count):
        got = tloader.shard_for_host(n, rank, count, seed=seed, shuffle=shuffle)
        np.testing.assert_array_equal(got, jshard(n, rank, count, seed=seed, shuffle=shuffle))
        shards.append(got)
    # the union over the ranks is the permutation padded with its own head
    perm = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    padded = np.concatenate([perm, perm[: (-n) % count]])
    interleaved = np.stack(shards, axis=1).reshape(-1)
    np.testing.assert_array_equal(interleaved, padded)


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


@pytest.mark.parametrize("n,world,per_rank,drop_last", [(12, 2, 2, True), (13, 2, 3, True), (17, 3, 2, True),
                                                         (13, 2, 3, False)])
def test_loader_per_host_global_batches(monkeypatch, n, world, per_rank, drop_last):
    """The ranks' batch k together are the one-process batch k of
    world * per_rank samples, as a set; as many batches on every rank."""
    one = tloader.Loader(_Indices(n), world * per_rank, seed=4, num_workers=1, drop_last=drop_last)
    one.set_epoch(2)
    want = [set(b["i"].tolist()) for b in one]
    assert len(want) == len(one)
    ranks = []
    monkeypatch.setattr(distributed, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(distributed, "process_index", lambda rank=rank: rank)
        lo = tloader.Loader(_Indices(n), per_rank, seed=4, num_workers=1, drop_last=drop_last)
        lo.set_epoch(2)
        ranks.append([b["i"].tolist() for b in lo])
        assert len(ranks[-1]) == len(lo)
    if drop_last:
        assert len(ranks[0]) == len(want)
        for k, batch in enumerate(want):
            assert set(sum((r[k] for r in ranks), [])) == batch
    else:  # the last global batch holds the padding's repeats
        assert all(len(r) == math.ceil(math.ceil(n / world) / per_rank) for r in ranks)
        for k, batch in enumerate(want[:-1]):
            assert set(sum((r[k] for r in ranks), [])) == batch


def test_loader_one_process_takes_the_epoch_permutation():
    """One process's batches are the epoch's seeded permutation, in order,
    the padded tail dropped."""
    lo = tloader.Loader(_Indices(9), 2, seed=1, num_workers=1)
    lo.set_epoch(3)
    perm = np.random.default_rng(1 + 3).permutation(9)
    assert [b["i"].tolist() for b in lo] == perm[:8].reshape(4, 2).tolist()
    assert len(lo) == 4


# ---- start-up, mesh ----

def test_initialize_without_variables_is_a_noop(monkeypatch):
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    assert initialize(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized() and distributed.process_count() == 1
    distributed.shutdown()  # nothing to leave


def test_initialize_one_process_is_a_noop(monkeypatch):
    monkeypatch.setenv("DCANET_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DCANET_NUM_PROCESSES", "1")
    monkeypatch.setenv("DCANET_PROCESS_ID", "0")
    assert initialize(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("unset", ["DCANET_COORDINATOR", "DCANET_PROCESS_ID"])
def test_initialize_refuses_a_partial_environment(monkeypatch, unset):
    """Two processes without a coordinator or a process id raise, rather
    than each training alone."""
    monkeypatch.setenv("DCANET_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DCANET_NUM_PROCESSES", "2")
    monkeypatch.setenv("DCANET_PROCESS_ID", "0")
    monkeypatch.delenv(unset)
    with pytest.raises(ValueError, match=unset):
        initialize(device="cpu")
    assert not dist.is_initialized()


def test_initialize_leaves_a_formed_group(steps):
    """Inside a group the caller formed, variables naming another (3
    processes at port 1) start nothing."""
    for rank in steps:
        assert rank["initialize_when_up"] == ("cpu", WORLD)


def test_all_reduce_sum_gradient_is_summed(steps):
    """Rank r sums t * (r + 1) and weights the sum by r + 1: the sum is
    3t on both ranks, and each rank's gradient is (1 + 2) * (r + 1)."""
    for r, res in enumerate(steps):
        summed, grad = res["all_reduce_sum"]
        assert summed.tolist() == [3.0, 6.0]
        assert grad.tolist() == [3.0 * (r + 1)] * 2


def test_mesh_and_shard_batch():
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_disp, mesh.rank) == (1, 1, 0)
    with pytest.raises(ValueError, match="disp axis must equal the number of processes"):
        make_mesh(n_disp=2)
    with pytest.raises(ValueError, match="must equal the number of processes"):
        make_mesh(n_data=2)
    m = Mesh(n_data=2, n_disp=1, rank=1)
    batch = {"a": torch.arange(6).reshape(6, 1), "b": torch.arange(6)}
    assert shard_batch(batch, m)["b"].tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({"a": torch.arange(5)}, m)


def test_run_config_fields_match_jax():
    from dcanet_tpu.config import RunConfig as JRunConfig

    jax_fields = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    del jax_fields["eval_every_epochs"]
    assert port_fields == jax_fields


# ---- BatchNorm and train steps over 2 ranks ----

def _bn_params(case):
    offset = case == "offset"
    shape = BN_OFFSET_SHAPE if offset else BN_CASES[case]
    rng = np.random.default_rng(len(case))
    c = shape[1]
    if offset:
        x = rng.standard_normal(shape) + BN_OFFSET_RATIO * rng.standard_normal((1, c) + (1,) * (len(shape) - 2))
    else:
        x = rng.standard_normal(shape) * 2.0 + 0.5
        x[shape[0] // 2:] += 3.0  # rank 1's shard has another mean
    return {
        "x": torch.from_numpy(x.astype(np.float32)),
        "g": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
        "weight": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
        "bias": torch.from_numpy(rng.normal(0.0, 0.1, c).astype(np.float32)),
        "running_mean": torch.from_numpy(rng.normal(0.0, 0.2, c).astype(np.float32)),
        "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
    }


def _global_batch():
    """Two pairs at 32x64: pair 0's gt all inside (0, maxdisp), about a third
    of pair 1's at or above maxdisp, so the ranks' valid counts differ."""
    rng = np.random.default_rng(11)
    left = rng.standard_normal((2, H, Wd, 3)).astype(np.float32)
    right = rng.standard_normal((2, H, Wd, 3)).astype(np.float32)
    disp = np.stack([rng.uniform(1.0, MAXDISP - 2.0, (H, Wd)), rng.uniform(1.0, 1.5 * MAXDISP, (H, Wd))])
    return left, right, disp.astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _torch_batch():
    left, right, disp = _global_batch()
    return {"left": _nchw(left), "right": _nchw(right), "disparity": torch.from_numpy(disp)}


@pytest.fixture(scope="module")
def weights():
    from test_torch_train import _flat_variables

    from dcanet_tpu_torch import weights as W

    flat = _flat_variables(1, seed=7)
    return flat, W.from_jax_variables(flat, 1)


@pytest.fixture(scope="module")
def launched(weights, tmp_path_factory):
    """Both 2-rank jobs, started at once: the BatchNorm cases and train
    steps, and `cli train` on a tiny SceneFlow tree (4 pairs; the crop is
    cut to 32x64 in the ranks and in the one-process run)."""
    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree

    tmp = tmp_path_factory.mktemp("parallel")
    root = write_sceneflow_tree(tmp / "sceneflow", 4, (48, 96), seed=0, max_disp=24)
    spec = {"bn": {case: _bn_params(case) for case in [*BN_CASES, "offset"]}, "batch": _torch_batch(),
            "state_dict": weights[1]}
    return {
        "steps": _start_ranks("steps", spec, tmp / "steps"),
        "cli": _start_ranks("cli", {"root": str(root), "logdir": str(tmp / "two")}, tmp / "cli"),
        "root": root, "tmp": tmp,
    }


@pytest.fixture(scope="module")
def steps(launched, one_process, jax_step):
    """The ranks' results of the "steps" job (joined after the one-process
    and JAX steps, which run meanwhile)."""
    return _join_ranks(launched["steps"])


@pytest.fixture(scope="module")
def one_process(weights):
    return {(case, tag): _step_run({"state_dict": weights[1]}, case, _torch_batch(), DTYPES[tag])
            for case, tag in STEP_IDS}


def test_ranks_valid_counts_differ():
    _, _, disp = _global_batch()
    counts = ((disp > 0) & (disp < MAXDISP)).reshape(2, -1).sum(1)
    assert counts[0] == H * Wd and 0.5 * H * Wd < counts[1] < 0.8 * H * Wd


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_global_batch_norm_matches_one_process(steps, case):
    params = _bn_params(case)
    want = _bn_run(params, params["x"], params["g"])
    ranks = [r["bn"][case] for r in steps]
    for k in ("y", "dx"):
        got = torch.cat([r[k] for r in ranks])
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    for k in ("dweight", "dbias"):  # each rank's share of the parameter gradient
        got = sum(r[k] for r in ranks)
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    for k in ("running_mean", "running_var"):  # from the global statistics, equal on every rank
        for r in ranks:
            np.testing.assert_allclose(r[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
        assert torch.equal(ranks[0][k], ranks[1][k])


def _rel_l2(got, want, floor=0.0) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)) / max(float(torch.linalg.vector_norm(want)), floor, 1e-30)


def test_global_batch_norm_offset_channels_match_float64(steps):
    """Channel means 30x their spread: the float32 global BatchNorm's
    output, input gradient and weight/bias gradients within 1e-5 (relative
    L2) of one float64 process, its running variance within 1e-6 (float32
    E[x^2] - E[x]^2 misses it by ~1e-5)."""
    params = _bn_params("offset")
    want = _bn_run({k: v.double() for k, v in params.items()}, params["x"].double(), params["g"].double())
    ranks = [r["bn"]["offset"] for r in steps]
    for k in ("y", "dx"):
        assert _rel_l2(torch.cat([r[k] for r in ranks]), want[k]) <= 1e-5, k
    for k in ("dweight", "dbias"):
        assert _rel_l2(sum(r[k] for r in ranks), want[k]) <= 1e-5, k
    for r in ranks:
        assert _rel_l2(r["running_mean"], want["running_mean"]) <= 1e-6
        assert _rel_l2(r["running_var"], want["running_var"]) <= 1e-6


def _scaled_close(got, want, atol):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


@pytest.mark.parametrize("case,tag", STEP_IDS)
def test_train_step_metrics_match_one_process(steps, one_process, case, tag):
    """float64 (second step): every metric within 1e-7 (grad_norm 1e-6: it
    is summed in float32). float32: loss terms rtol 1e-5 and grad norm rtol
    1e-3, the bound of tests/test_torch_train_step.py (see STEPS)."""
    want = one_process[case, tag]["metrics"]
    for r in steps:
        got = r["steps"][case, tag]["metrics"]
        assert set(got) == set(want)
        for k, v in want.items():
            if tag == "f64":
                rel = 1e-6 if k == "grad_norm" else 1e-7
            else:
                rel = 1e-3 if k == "grad_norm" else 1e-5
            assert got[k] == pytest.approx(v, rel=rel), k
    assert steps[0]["steps"][case, tag]["metrics"] == steps[1]["steps"][case, tag]["metrics"]


@pytest.mark.parametrize("case,tag", STEP_IDS)
def test_train_step_gradients_match_one_process(steps, one_process, case, tag):
    """The ranks hold the same summed gradient, bit for bit. In float64 (the
    second step) each parameter's gradient is within 1e-7 (relative L2) of
    the one-process gradient, relative to max(its norm, 1e-6 x the whole
    gradient's norm): a conv bias before a BatchNorm has an exact gradient
    of 0. (Adam's steps carry 1e-16 roundings to ~6e-9 by a third step.)"""
    want = one_process[case, tag]["grads"]
    g0, g1 = (r["steps"][case, tag]["grads"] for r in steps)
    assert set(g0) == set(want)
    floor = 1e-6 * float(torch.sqrt(sum(torch.linalg.vector_norm(w.double()) ** 2 for w in want.values())))
    for name, w in want.items():
        assert torch.equal(g0[name], g1[name]), name
        if tag == "f64":
            err = _rel_l2(g0[name], w, floor)
            assert err <= 1e-7, (name, err)


@pytest.mark.parametrize("case,tag", STEP_IDS)
def test_train_step_bn_statistics_match_one_process(steps, one_process, case, tag):
    want = one_process[case, tag]["state_dict"]
    for r in steps:
        got = r["steps"][case, tag]["state_dict"]
        for k, v in want.items():
            if "running" in k:
                _scaled_close(got[k].numpy(), v.numpy(), atol=1e-5 if tag == "f32" else 1e-10)
            elif "num_batches_tracked" in k:
                assert int(got[k]) == int(v), k


@pytest.mark.parametrize("case,tag", STEP_IDS)
def test_train_step_parameters_match_one_process(steps, one_process, weights, case, tag):
    """The replicas' parameters are equal bit for bit. float64, after two
    steps: each parameter within 1e-7 (relative L2) of one process's.
    float32, Adam's first step, by the firm rule of
    tests/test_torch_train_step.py: where both steps are within 0.1 % of
    +-lr they agree to 1e-5; the rest stay under 1 % of the elements and no
    step exceeds lr."""
    lr, start = 1e-3, weights[1]
    want = one_process[case, tag]["state_dict"]
    s0, s1 = (r["steps"][case, tag]["state_dict"] for r in steps)
    loose = total = 0
    for k in one_process[case, tag]["grads"]:
        assert torch.equal(s0[k], s1[k]), k
        if tag == "f64":
            assert _rel_l2(s0[k], want[k]) <= 1e-7, k
            continue
        d_got, d_want = (s0[k] - start[k]).numpy(), (want[k] - start[k]).numpy()
        firm = (np.sign(d_got) == np.sign(d_want)) & (np.minimum(np.abs(d_got), np.abs(d_want)) > 0.999 * lr)
        np.testing.assert_allclose(d_got[firm], d_want[firm], atol=1e-5, rtol=0, err_msg=k)
        assert np.abs(d_got).max() <= 1.01 * lr, k
        loose += int((~firm).sum())
        total += d_got.size
    assert loose <= 0.01 * total, (loose, total)


@pytest.fixture(scope="module")
def jax_step(weights):
    """The JAX train_step on the global batch (sceneflow preset)."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from dcanet_tpu.models import DCANet as FlaxDCANet
    from dcanet_tpu.train import loop as jloop
    from dcanet_tpu.train import schedule as jsched
    from dcanet_tpu.train.state import TrainState as FlaxTrainState

    variables = unflatten_dict(weights[0], sep="/")
    fmodel = FlaxDCANet(maxdisp=MAXDISP, num_cva=1)
    tx = jsched.make_adam(jsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    params = jax.tree.map(jnp.asarray, variables["params"])
    fstate = FlaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), apply_fn=fmodel.apply, tx=tx,
    )
    left, right, disp = _global_batch()
    batch = {"left": jnp.asarray(left), "right": jnp.asarray(right), "disparity": jnp.asarray(disp)}
    new_state, metrics = jloop.train_step(fstate, batch, jloop.LossConfig(max_disp=MAXDISP))
    return {k: float(v) for k, v in metrics.items()}, new_state.batch_stats


@pytest.mark.parametrize("key", ["total", "focal", "smooth_l1", "grad_norm", "epe"])
def test_two_rank_step_matches_jax(steps, jax_step, key):
    got, want = steps[0]["steps"]["sceneflow", "f32"]["metrics"][key], jax_step[0][key]
    if key == "epe":
        assert got == pytest.approx(want, abs=2e-2)
    else:
        assert got == pytest.approx(want, rel=1e-3 if key == "grad_norm" else 1e-4)


def test_two_rank_step_bn_statistics_match_jax(steps, jax_step):
    from test_torch_train import _flatten

    from dcanet_tpu_torch import weights as W

    got = W.to_jax_variables(steps[1]["steps"]["sceneflow", "f32"]["state_dict"], 1)
    want = {f"batch_stats/{k}": np.asarray(v) for k, v in _flatten(jax_step[1]).items()}
    assert want
    for k, v in want.items():
        _scaled_close(got[k], v, atol=1e-3)


# ---- cli train over 2 ranks ----

@pytest.fixture(scope="module")
def cli_runs(launched, steps):
    """One process and 2 ranks, each 1 epoch of 2 steps at --batch-size 2,
    then a resumed one, in float32 and in float64; by dtype tag: the
    one-process run, the ranks' runs, and their logdirs."""
    from dcanet_tpu_torch.data import datasets

    root, tmp = launched["root"], launched["tmp"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(datasets.PRESETS, "sceneflow", dict(datasets.PRESETS["sceneflow"], crop=(32, 64)))
        one = {tag: _cli_train(root, tmp / f"one_{tag}", dtype) for tag, dtype in DTYPES.items()}
    ranks = _join_ranks(launched["cli"])
    return {tag: (one[tag]["hist"], [r[tag] for r in ranks], tmp / f"one_{tag}", tmp / f"two_{tag}")
            for tag in DTYPES} | {"errors": [r["errors"] for r in ranks]}


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


CLI_KEYS = ("total", "focal", "smooth_l1", "grad_norm", "epe")


def _cli_histories(cli_runs, tag):
    """The one-process records and each rank's, after checking that the
    ranks' records are equal, finite and of steps 0-3."""
    one, ranks, _, _ = cli_runs[tag]
    assert [r["step"] for r in one] == [0, 1, 2, 3]
    h0, h1 = (rank["hist"] for rank in ranks)
    assert [r["step"] for r in h0] == [0, 1, 2, 3]
    assert [{k: r[k] for k in CLI_KEYS} for r in h0] == [{k: r[k] for k in CLI_KEYS} for r in h1]
    assert all(np.isfinite(r[k]) for r in h0 for k in CLI_KEYS)
    return one, h0


def test_cli_train_two_ranks_match_one_process(cli_runs):
    one, h0 = _cli_histories(cli_runs, "f32")
    # before any update: the same weights on the same global batch
    for k in ("total", "focal", "smooth_l1"):
        assert h0[0][k] == pytest.approx(one[0][k], rel=1e-5), k
    assert h0[0]["grad_norm"] == pytest.approx(one[0]["grad_norm"], rel=1e-3)
    # after it, float32 rounding grows through Adam in one process alone (a
    # thread count moves it); the float64 test below bounds every step
    print("cli train, 2 ranks against one process, relative:", {
        (r["step"], k): abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(h0, one) for k in ("total", "grad_norm")})


def test_cli_train_two_ranks_match_one_process_float64(cli_runs):
    """Every step, the resumed epoch's included: the metrics within 1e-7
    (grad_norm 1e-6: it is summed in float32)."""
    one, h0 = _cli_histories(cli_runs, "f64")
    print("cli train in float64, 2 ranks against one process, relative:", {
        (r["step"], k): abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(h0, one) for k in CLI_KEYS})
    for got, want in zip(h0, one):
        for k in CLI_KEYS:
            rel = 1e-6 if k == "grad_norm" else 1e-7
            assert got[k] == pytest.approx(want[k], rel=rel), (got["step"], k)


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cli_train_two_ranks_log_as_one_process(cli_runs, tag):
    _, _, one_dir, two_dir = cli_runs[tag]
    one, two = _rows(one_dir / "metrics.jsonl"), _rows(two_dir / "metrics.jsonl")
    assert [r["step"] for r in two] == [r["step"] for r in one] == [1, 2, 3, 4]
    assert [sorted(r) for r in two] == [sorted(r) for r in one]
    assert len(_rows(two_dir / "train_log.jsonl")) == len(_rows(one_dir / "train_log.jsonl")) == 4
    assert sorted(p.name for p in (two_dir / "ckpt").iterdir()) == ["ckpt_00000002.pt", "ckpt_00000004.pt"]


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cli_train_rank1_writes_no_file(cli_runs, tag):
    _, ranks, _, _ = cli_runs[tag]
    assert ranks[1]["written"] == []
    names = {os.path.basename(p) for p in ranks[0]["written"]}
    assert {"train_log.jsonl", "metrics.jsonl", "ckpt_00000002.pt", "ckpt_00000004.pt"} <= names


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cli_train_replicas_end_equal(cli_runs, tag):
    """Parameters, BatchNorm buffers and Adam state equal bit for bit."""
    _, ranks, _, _ = cli_runs[tag]
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_cli_train_errors_over_two_ranks(cli_runs):
    for errors in cli_runs["errors"]:
        assert errors["batch_3"] == "batch_size 3 not divisible by n_data_shards 2"
        assert "must equal the number of processes" in errors["n_data_1"]


@pytest.mark.parametrize("cmd,extra,error", [
    ("train", ["--n-disp-shards", "2"], ValueError),  # one process, a disp axis of 2
    ("train", ["--n-data-shards", "2"], ValueError),
    ("eval", ["--n-disp-shards", "2"], ValueError),  # one process, a disp axis of 2
])
def test_cli_parallel_flags_refused_in_one_process(tmp_path, cmd, extra, error):
    with pytest.raises(error):
        cli.main([cmd, "--preset", "sceneflow", "--data-root", str(tmp_path), "--logdir", str(tmp_path / "run"),
                  "--maxdisp", "32", "--device", "cpu", *extra])
    assert not (tmp_path / "run").exists()
