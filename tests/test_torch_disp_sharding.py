"""Disparity-axis sharding of the port's eval (parallel/sharding.py) on the
CPU: ranks under gloo against one process and against the JAX package.

- the plan: D=8 on 2 and 3 ranks, D=60 on 8 ranks (4,4,4,4,4,4,3,3 half
  planes); at D/2 < n or an odd D it warns and the forward runs unsharded,
  with no collective, equal to the plain forward bit for bit;
- the plain gwc and concat volumes with `planes` equal to slices of the
  whole ones, a range past W (all zeros) included;
- each D-sharded op (3x3x3 conv stride 1 at both resolutions and stride 2,
  the CVA's AvgPool3d, the k3 s2 transposed conv, the trilinear 2x) over 2
  and 3 ranks against the unsharded op on the same input, float64, 1e-12;
- DCANet eval (num_cva 1 and 2, maxdisp 32, a 64x128 pair, weights from
  `weights.from_jax_variables` on seeded numpy arrays, the BatchNorm
  statistics those of one train-mode forward of the pair) sharded over 2
  and 3 ranks (3: half planes 2,1,1): in float64 against the port's unsharded
  forward, disparity 1e-9 px and class logits 1e-10 after scaling by
  max(|logits|, 1); in float32 against the JAX DCANet eval forward on the
  same variables, 5e-3 px and 1e-4 scaled (the eval parity of
  tests/test_torch_dcanet.py); in bf16 autocast (BatchNorm folded, none
  outside Guidance's runs on any rank) against the port's unsharded bf16
  forward, mean |diff| < 0.25 px (tests/test_torch_fold_eval.py's bound);
- `cli eval --n-disp-shards 2` over 2 ranks (the group formed by
  `initialize` from the DCANET_* variables, and left at the end) on a
  synthetic ETH3D tree, the protocol's 768x1024 canvas cut to 64x128,
  against one process and against the JAX `cmd_eval` with n_disp_shards=2
  on the conftest's 8 virtual CPU devices: EPE within 5e-3 px, D1 and
  >1/2/3 px within 1e-3, each pair's confusion within 1 % of its total in
  L1 (tests/test_torch_eval.py's bounds); rank 1 writes no file, and the
  ranks return the same results;
- the refusals: `gwcnet-gc` with a plan, a disp axis that is not the
  number of processes; a (data, disp) grid gives a plan (its training is
  tests/test_torch_disp_train.py's).

The ranks are child processes (`_child`), each joined within
CHILD_TIMEOUT_S and killed after it; a child's traceback fails the test.
This module imports no JAX at its top, because the children import it.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from chip_smoke import calibrate_batch_norm, seeded_flax_variables, writes_under
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.data import eval_protocol as tprotocol
from dcanet_tpu_torch.data.synthetic import write_eth3d_tree
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.models.registry import make_model
from dcanet_tpu_torch.nn.layers import avg_pool3d_torch, run_sharded, torch_conv_transpose3d
from dcanet_tpu_torch.ops.cost_volume import build_concat_volume, build_gwc_volume
from dcanet_tpu_torch.ops.upsample import resize_trilinear
from dcanet_tpu_torch.parallel import DispPlan, Mesh, distributed, initialize, make_disp_constraint, make_mesh
from dcanet_tpu_torch.train import metrics as tmetrics

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CHILD_TIMEOUT_S = 150
WORLDS = (2, 3)
MAXDISP, H, Wd = 32, 64, 128
NUM_CVAS = (1, 2)
CLI_MODEL, CLI_NUM_CVA = "dcanet-cva1", 1
ETH3D_CANVAS, ETH3D_HW, ETH3D_PAIRS = (64, 128), (56, 120), 2
ENV_VARS = ("DCANET_COORDINATOR", "DCANET_NUM_PROCESSES", "DCANET_PROCESS_ID")
OPS = ("conv_s1", "conv_s1_half", "conv_s2", "avg_pool", "deconv", "resize")
METRIC_TOLS = {"epe": 5e-3, "d1": 1e-3, "thres1": 1e-3, "thres2": 1e-3, "thres3": 1e-3}


# ---- the ranks ----

_CHILD = "import sys; sys.path[:0] = sys.argv[1:3]; import {} as t; t._child(*sys.argv[3:])"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(world: int, spec: dict, workdir, module: str = "test_torch_disp_sharding") -> dict:
    """Start `module`'s `_child` as `world` processes, each given its rank,
    the world, two free ports, the spec's path and its output's path;
    `_join_ranks` waits."""
    workdir.mkdir(parents=True, exist_ok=True)
    spec_path = workdir / "spec.pt"
    torch.save(spec, spec_path)
    ports = [str(_free_port()), str(_free_port())]
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(world):
        with open(workdir / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD.format(module), TESTS, REPO, str(rank), str(world), *ports,
                 str(spec_path), str(workdir / f"rank{rank}.pt")],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            ))
    return {"procs": procs, "workdir": workdir, "deadline": time.monotonic() + CHILD_TIMEOUT_S}


def _join_ranks(handle: dict) -> list:
    """Wait for the ranks until CHILD_TIMEOUT_S after their start, kill any
    left; their results, by rank, or a failure with each failed rank's log."""
    procs, workdir = handle["procs"], handle["workdir"]
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
        text = (workdir / f"rank{rank}.log").read_text()
        assert p.returncode == 0, f"rank {rank} of {len(procs)} exited {p.returncode}:\n{text[-6000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _child(rank, world, cli_port, port, spec_path, out_path):
    """A rank on the CPU, one thread: with 2 ranks `cli eval` first, which
    forms its group from the DCANET_* variables and leaves it at its end;
    then, in a group formed by `initialize`, the ops and the forwards."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    spec = torch.load(spec_path, weights_only=False)
    tprotocol.ETH3D_H, tprotocol.ETH3D_W = ETH3D_CANVAS
    result = {}
    if world == 2:
        os.environ.update(DCANET_COORDINATOR=f"127.0.0.1:{cli_port}", DCANET_NUM_PROCESSES=str(world),
                          DCANET_PROCESS_ID=str(rank))
        result["cli"] = _cli_job(spec)
        result["group_left"] = not dist.is_initialized()
    os.environ.update(DCANET_COORDINATOR=f"127.0.0.1:{port}", DCANET_NUM_PROCESSES=str(world),
                      DCANET_PROCESS_ID=str(rank))
    initialize(device="cpu")
    mesh = make_mesh(1, world)
    result["mesh"] = (mesh.n_data, mesh.n_disp, mesh.rank, mesh.disp_rank)
    plan = make_disp_constraint(mesh)
    result["ops"] = _ops_job(spec, plan)
    result["models"] = _models_job(spec, plan)
    distributed.shutdown()
    torch.save(result, out_path)


# ---- the ops ----

def _op_cases(seed: int):
    """name -> (module or fn, its input), float64: D = MAXDISP / 4 planes at
    the volume's resolution, D / 2 at the CVA's half resolution."""
    torch.manual_seed(seed)
    d = MAXDISP // 4

    def vol(planes, h=5, w=6):
        return torch.randn(1, 4, planes, h, w, dtype=torch.float64)

    def conv(stride):
        return nn.Conv3d(4, 3, 3, stride, 1, bias=True).double()

    return {
        "conv_s1": (conv(1), vol(d)),
        "conv_s1_half": (conv(1), vol(d // 2)),
        "conv_s2": (conv(2), vol(d, 6, 8)),
        "avg_pool": (avg_pool3d_torch(), vol(d, 6, 8)),
        "deconv": (torch_conv_transpose3d(4, 3).double(), vol(d // 2)),
        "resize": (lambda x, shard=None: resize_trilinear(x, 2, shard), vol(d // 2)),
    }


def _run_op(fn, x, shard=None):
    return run_sharded(fn, x, shard) if isinstance(fn, nn.Module) else fn(x, shard)


def _ops_job(spec, plan):
    """Each op on this rank's slab against the rank's planes of the
    unsharded op's output: the largest |difference| per op."""
    shard = plan.split(MAXDISP // 4)
    errs = {}
    with torch.no_grad():
        for name, (fn, x) in _op_cases(spec["seed"]).items():
            lo, hi = shard.span(x.shape[2])
            want = _run_op(fn, x)
            olo, ohi = shard.span(want.shape[2])
            got = _run_op(fn, x[:, :, lo:hi].contiguous(), shard)
            assert got.shape == want[:, :, olo:ohi].shape, (name, got.shape, want.shape)
            errs[name] = float((got - want[:, :, olo:ohi]).abs().max())
    return errs


# ---- the forwards ----

def _pair(dtype):
    rng = np.random.default_rng(3)
    left, right = (torch.from_numpy(rng.standard_normal((1, 3, H, Wd)).astype(np.float32)) for _ in range(2))
    return left.to(dtype), right.to(dtype)


def _model(spec, num_cva, dtype, plan=None):
    """DCANet in `dtype`; float32 weights for bf16, which runs under autocast."""
    model = DCANet(maxdisp=MAXDISP, num_cva=num_cva, constrain_volume=plan)
    model.load_state_dict(W.from_jax_variables(spec["flat"][num_cva], num_cva), strict=True)
    return model.to(torch.float32 if dtype == torch.bfloat16 else dtype).eval()


def _forward(model, dtype):
    """The eval forward in `dtype` (bf16: under bf16 autocast, BatchNorm
    folded), and the BatchNorm modules outside Guidance that ran (Guidance's
    ResidualBlocks and `norm1` keep their BN, as in the JAX package)."""
    ran = set()
    handles = [m.register_forward_hook(lambda *_, n=n: ran.add(n)) for n, m in model.named_modules()
               if isinstance(m, nn.modules.batchnorm._BatchNorm) and not n.startswith("guidance.")]
    bf16 = dtype == torch.bfloat16
    try:
        with torch.inference_mode(), torch.autocast("cpu", torch.bfloat16, enabled=bf16):
            out = model(*_pair(torch.float32 if bf16 else dtype))
    finally:
        for h in handles:
            h.remove()
    return {"disparity": out.disparity.clone(), "logits": [lg.clone() for lg in out.class_logits],
            "bn_ran": sorted(ran)}


MODEL_DTYPES = (("f64", torch.float64), ("f32", torch.float32), ("bf16", torch.bfloat16))


def _models_job(spec, plan):
    return {(num_cva, tag): _forward(_model(spec, num_cva, dtype, plan), dtype)
            for num_cva in NUM_CVAS for tag, dtype in MODEL_DTYPES}


# ---- cli eval ----

def _eval_args(root, logdir, ckpt, *extra):
    return ["eval", "--preset", "eth3d", "--dataset", "eth3d", "--data-root", str(root), "--logdir", str(logdir),
            "--ckpt", str(ckpt), "--model", CLI_MODEL, "--maxdisp", str(MAXDISP), "--log-images", "1",
            "--device", "cpu", *extra]


def _record_confusions(mp, module, to_numpy):
    """Wrap module.disparity_class_confusion; returns the list of its outputs."""
    calls, inner = [], module.disparity_class_confusion

    def wrapped(*args, **kw):
        out = inner(*args, **kw)
        calls.append(np.array(to_numpy(out)))
        return out

    mp.setattr(module, "disparity_class_confusion", wrapped)
    return calls


def _cli_job(spec):
    """`cli eval --n-disp-shards 2` with its confusions and the paths it
    writes."""
    with pytest.MonkeyPatch.context() as mp:
        calls = _record_confusions(mp, tmetrics, torch.Tensor.numpy)
        with writes_under(str(spec["logdir"]), []) as written:
            results = cli.main(_eval_args(spec["root"], spec["logdir"], spec["ckpt"], "--n-disp-shards", "2"))
    return {"results": results, "confusions": calls, "written": written}


def _jax_eth3d_canvas(item, preset):
    """The JAX package's ETH3D protocol on the ETH3D_CANVAS canvas: zero-pad
    the top and the right of images and gt (dcanet_tpu/data/eval_protocol.py
    pads to 768x1024)."""
    assert preset == "eth3d"
    h, w = item["left"].shape[:2]
    top, rp = ETH3D_CANVAS[0] - h, ETH3D_CANVAS[1] - w
    left, right = (np.pad(item[k], [(top, 0), (0, rp), (0, 0)]) for k in ("left", "right"))
    return left, right, np.pad(item["disparity"], [(top, 0), (0, rp)]), (0, 0)


def _jax_cmd_eval(root, logdir, flat):
    """The JAX `cmd_eval` with n_disp_shards=2 from the flat variables; its
    results and confusions. Its `_make_state` builds the model as it does
    and takes the variables as they are (its init is not run)."""
    import types

    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict
    from jax import tree

    from dcanet_tpu import cli as jcli
    from dcanet_tpu.config import preset as jpreset
    from dcanet_tpu.data import eval_protocol as jprotocol
    from dcanet_tpu.models import make_model as jmake_model
    from dcanet_tpu.parallel import make_disp_constraint as jconstraint
    from dcanet_tpu.train import metrics as jmetrics

    variables = unflatten_dict(flat, sep="/")

    def seeded_state(cfg, steps_per_epoch, mesh=None):
        assert mesh is not None and mesh.shape["disp"] == 2
        model = jmake_model(cfg.model, maxdisp=cfg.maxdisp, constrain_volume=jconstraint(mesh))
        return model, types.SimpleNamespace(step=jnp.zeros((), jnp.int32),
                                            params=tree.map(jnp.asarray, variables["params"]),
                                            batch_stats=tree.map(jnp.asarray, variables["batch_stats"]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_make_state", seeded_state)
        mp.setattr(jprotocol, "eval_transform", _jax_eth3d_canvas)
        calls = _record_confusions(mp, jmetrics, np.asarray)
        cfg = jpreset("eth3d", data_root=str(root), dataset="eth3d", maxdisp=MAXDISP, model=CLI_MODEL,
                      logdir=str(logdir), n_disp_shards=2)
        return jcli.cmd_eval(cfg), calls


def _jax_forward(flat, num_cva):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from dcanet_tpu.models import DCANet as FlaxDCANet

    left, right = (x.numpy().transpose(0, 2, 3, 1) for x in _pair(torch.float32))
    model = FlaxDCANet(maxdisp=MAXDISP, num_cva=num_cva)
    out = jax.jit(lambda v, l, r: model.apply(v, l, r, train=False))(
        unflatten_dict(flat, sep="/"), jnp.asarray(left), jnp.asarray(right))
    return {"disparity": np.asarray(out.disparity), "logits": [np.asarray(lg) for lg in out.class_logits]}


def _calibrated_variables(num_cva, seed):
    """Flat flax variables for DCANet: seeded numpy arrays
    (`chip_smoke.seeded_flax_variables`), then the BatchNorm statistics of
    one train-mode forward of the test pair (`chip_smoke.calibrate_batch_norm`),
    so that activations stay of order 1 (the seeded statistics put the
    class logits near 1e13, where the softmax is one-hot and the
    disparities whole numbers)."""
    model = DCANet(maxdisp=MAXDISP, num_cva=num_cva)
    model.load_state_dict(W.from_jax_variables(seeded_flax_variables(model, seed), num_cva), strict=True)
    calibrate_batch_norm(model, *_pair(torch.float32))
    return W.to_jax_variables(model.state_dict(), num_cva)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks over 2 and 3 processes, started first; meanwhile in this
    process the unsharded port forwards, the one-process `cli eval` and the
    JAX references."""
    tmp = tmp_path_factory.mktemp("disp")
    flat = {n: _calibrated_variables(n, seed=10 + n) for n in NUM_CVAS}
    root = write_eth3d_tree(tmp / "eth3d", ETH3D_PAIRS, ETH3D_HW, seed=5, max_disp=20)
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    model = DCANet(maxdisp=MAXDISP, num_cva=CLI_NUM_CVA)
    model.load_state_dict(W.from_jax_variables(flat[CLI_NUM_CVA], CLI_NUM_CVA), strict=True)
    torch.save({"step": 7, "model": model.state_dict()}, ckpt / "ckpt_00000007.pt")
    spec = {"seed": 21, "flat": flat, "root": root, "ckpt": ckpt}
    handles = {world: _start_ranks(world, dict(spec, logdir=tmp / f"ranks{world}"), tmp / f"w{world}")
               for world in WORLDS}

    one = {(n, tag): _forward(_model(spec, n, dtype), dtype) for n in NUM_CVAS for tag, dtype in MODEL_DTYPES}
    jax_fwd = {n: _jax_forward(flat[n], n) for n in NUM_CVAS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tprotocol, "ETH3D_H", ETH3D_CANVAS[0])
        mp.setattr(tprotocol, "ETH3D_W", ETH3D_CANVAS[1])
        calls = _record_confusions(mp, tmetrics, torch.Tensor.numpy)
        cli_one = cli.main(_eval_args(root, tmp / "one", ckpt))
    jax_cli, jax_calls = _jax_cmd_eval(root, tmp / "jax", flat[CLI_NUM_CVA])
    ranks = {world: _join_ranks(h) for world, h in handles.items()}
    return dict(ranks=ranks, one=one, jax_fwd=jax_fwd, cli_one=cli_one, cli_one_calls=calls, jax_cli=jax_cli,
                jax_calls=jax_calls, logdir=tmp / "ranks2")


# ---- the plan ----

@pytest.mark.parametrize("d,n,counts", [
    (8, 2, (2, 2)), (8, 3, (2, 1, 1)), (60, 8, (4, 4, 4, 4, 4, 4, 3, 3)),
])
def test_plan_ranges(d, n, counts):
    shards = [DispPlan(n, r).split(d) for r in range(n)]
    assert all(s.counts == counts for s in shards)
    planes = [s.planes for s in shards]
    assert planes[0][0] == 0 and planes[-1][1] == d
    assert all(a[1] == b[0] and a[0] % 2 == 0 for a, b in zip(planes, planes[1:]))
    assert [s.half_planes for s in shards] == [(p0 // 2, p1 // 2) for p0, p1 in planes]
    assert [s.span(d // 2) for s in shards] == [s.half_planes for s in shards]


@pytest.mark.parametrize("d,n", [(6, 4), (60, 31), (9, 2)])
def test_plan_replicates_with_a_warning(d, n):
    """D/2 < n, or an odd D: every rank takes the whole volume."""
    with pytest.warns(UserWarning, match="disp-sharding skipped"):
        assert DispPlan(n, 0).split(d) is None


def test_replicated_forward_warns_and_matches_the_plain_forward():
    """D/2 = 2 < 3 ranks: the plan warns and the forward is the plain one,
    bit for bit, with no collective (there is no process group here)."""
    torch.manual_seed(0)
    plain = DCANet(maxdisp=16, num_cva=1).eval()
    planned = DCANet(maxdisp=16, num_cva=1, constrain_volume=make_disp_constraint(Mesh(1, 3, 0, 1))).eval()
    planned.load_state_dict(plain.state_dict())
    x, y = torch.randn(1, 3, 32, 64), torch.randn(1, 3, 32, 64)
    with torch.no_grad(), pytest.warns(UserWarning, match="D=4 gives 2 pair"):
        got = planned(x, y)
    want = plain(x, y)
    assert torch.equal(got.disparity, want.disparity)
    assert all(torch.equal(a, b) for a, b in zip(got.class_logits, want.class_logits))


# ---- the plane range of the plain volumes ----

@pytest.mark.parametrize("planes", [(0, 12), (0, 4), (4, 8), (6, 12), (9, 10), (10, 12)])
@pytest.mark.parametrize("builder", ["gwc", "concat"])
def test_plain_volume_planes_are_slices(rng, builder, planes):
    """W = 10: the ranges from 10 on lie past W and are all zeros."""
    left, right = (torch.from_numpy(rng.standard_normal((2, 8, 3, 10)).astype(np.float32)) for _ in range(2))
    build = {"gwc": lambda p: build_gwc_volume(left, right, 12, 4, p),
             "concat": lambda p: build_concat_volume(left, right, 12, p)}[builder]
    got, whole = build(planes), build(None)
    assert torch.equal(got, whole[:, :, planes[0]:planes[1]])
    if planes[0] >= 10:
        assert not got.any()


@pytest.mark.parametrize("planes", [(3, 3), (-1, 4), (4, 13)])
def test_plain_volume_rejects_bad_ranges(planes):
    x = torch.zeros(1, 8, 2, 10)
    with pytest.raises(ValueError, match="plane range"):
        build_gwc_volume(x, x, 12, 4, planes)


# ---- the ranks' results ----

def test_mesh_places_the_ranks_on_the_disp_axis(runs):
    for world, ranks in runs["ranks"].items():
        assert [r["mesh"] for r in ranks] == [(1, world, 0, r) for r in range(world)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", OPS)
def test_sharded_op_matches_unsharded(runs, op, world):
    for rank in runs["ranks"][world]:
        assert rank["ops"][op] <= 1e-12


def _scaled(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_cva", NUM_CVAS)
def test_sharded_dcanet_matches_port_float64(runs, num_cva, world):
    want = runs["one"][num_cva, "f64"]
    for rank in runs["ranks"][world]:
        got = rank["models"][num_cva, "f64"]
        assert got["disparity"].dtype == torch.float64
        assert float((got["disparity"] - want["disparity"]).abs().max()) <= 1e-9
        assert len(got["logits"]) == num_cva
        for g, w in zip(got["logits"], want["logits"]):
            assert g.shape == w.shape == (1, MAXDISP // 8, H // 8, Wd // 8)
            assert _scaled(g, w) <= 1e-10


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_cva", NUM_CVAS)
def test_sharded_dcanet_matches_jax_float32(runs, num_cva, world):
    want = runs["jax_fwd"][num_cva]
    for rank in runs["ranks"][world]:
        got = rank["models"][num_cva, "f32"]
        np.testing.assert_allclose(got["disparity"].numpy(), want["disparity"], atol=5e-3, rtol=0)
        for g, w in zip(got["logits"], want["logits"]):
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-4, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_cva", NUM_CVAS)
def test_sharded_bf16_eval_folds_and_matches_one_process(runs, num_cva, world):
    """bf16 autocast: on every rank and in one process, no BatchNorm outside
    Guidance runs (`run_sharded` folds each into its conv on the halo-padded
    slab), and the disparity is within 0.25 px mean of one process's (the
    bound of tests/test_torch_fold_eval.py)."""
    want = runs["one"][num_cva, "bf16"]
    assert want["bn_ran"] == [] and len(runs["one"][num_cva, "f32"]["bn_ran"]) > 40
    for r, rank in enumerate(runs["ranks"][world]):
        got = rank["models"][num_cva, "bf16"]
        assert got["bn_ran"] == []
        err = float((got["disparity"] - want["disparity"]).abs().mean())
        print(f"[disp] bf16 eval, num_cva {num_cva}, rank {r} of {world}: mean |diff| {err:.3e} px from one process")
        assert got["disparity"].dtype == torch.float32 and err < 0.25


# ---- cli eval ----

@pytest.mark.parametrize("key", sorted(METRIC_TOLS))
def test_cli_eval_two_ranks_match_one_process_and_jax(runs, key):
    got = runs["ranks"][2][0]["cli"]["results"][key]
    assert np.isfinite(got)
    assert got == pytest.approx(runs["cli_one"][key], abs=METRIC_TOLS[key])
    assert got == pytest.approx(runs["jax_cli"][key], abs=METRIC_TOLS[key])


@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_cli_eval_confusions_match(runs, against):
    """ETH3D_PAIRS pairs x 1 CVA volume; each within 1 % of its total."""
    want = runs["cli_one_calls"] if against == "one_process" else runs["jax_calls"]
    for rank in runs["ranks"][2]:
        got = rank["cli"]["confusions"]
        assert len(got) == len(want) == ETH3D_PAIRS
        for g, w in zip(got, want):
            assert g.shape == w.shape == (MAXDISP // 8, MAXDISP // 8)
            assert g.sum() == w.sum() > 0
            assert np.abs(g - w).sum() <= 0.01 * w.sum()


def test_cli_eval_ranks_return_the_same_results(runs):
    r0, r1 = (r["cli"]["results"] for r in runs["ranks"][2])
    assert r0 == r1
    assert {"epe", "d1", "miou", "vol1/miou", "ms_per_pair"} <= set(r0)


def test_cli_eval_rank1_writes_no_file(runs):
    r0, r1 = (r["cli"]["written"] for r in runs["ranks"][2])
    assert r1 == []
    names = {os.path.basename(p) for p in r0}
    assert {"metrics.jsonl", "eval_sample0_00000007.png", "eval_sample0_probmass_vol1_00000007.png"} <= names
    assert (runs["logdir"] / "metrics.jsonl").exists()


def test_cli_eval_leaves_the_group_it_formed(runs):
    assert all(r["group_left"] for r in runs["ranks"][2])


# ---- refusals ----

@pytest.mark.parametrize("name", ["gwcnet-gc", "gwcnet-g", "ganet"])
def test_models_without_the_field_refuse_a_plan(name):
    with pytest.raises(TypeError, match="constrain_volume"):
        make_model(name, maxdisp=MAXDISP, constrain_volume=make_disp_constraint(Mesh(1, 2, 0, 0)))


def test_disp_mesh_must_equal_the_processes():
    with pytest.raises(ValueError, match="disp axis must equal the number of processes"):
        make_mesh(1, 2)
    plan = make_disp_constraint(Mesh(2, 2, 1, 1))  # a (data, disp) grid: the plan of its disp axis
    assert isinstance(plan, DispPlan) and (plan.n, plan.rank) == (2, 1)
    assert plan.split(8).planes == (4, 8)
