"""The gwc cost-volume kernel module of the port (dcanet_tpu_torch.kernels.gwc).

On the CPU: the plain version against the JAX package's Pallas kernel run in
interpret mode, the dispatcher's CPU path, the wrapper's input checks, and
numpy emulations of the forward and backward kernels' index maps (their
tiles read from csrc/gwc.cu).
The CUDA kernel itself is compared with its plain version by the card-only
test below and by chip_smoke.py. The card's machine has no JAX, so JAX is
imported inside the one test that needs it and the card-only test uses no
fixture of tests/conftest.py; there, run:
    python -m pytest --noconftest -m cuda tests/test_torch_gwc.py
"""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import dcanet_tpu_torch.kernels.gwc as G

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_gwc_interpret(left, right, maxdisp, groups):
    """dcanet_tpu's Pallas gwc kernel in interpret mode (no TPU here)."""
    import dcanet_tpu.kernels.gwc as K
    import jax.numpy as jnp

    orig = K.pl.pallas_call

    @functools.wraps(orig)
    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    K.pl.pallas_call = patched
    try:
        return K._gwc_forward(jnp.asarray(left), jnp.asarray(right), maxdisp, groups)
    finally:
        K.pl.pallas_call = orig


def _features(rng, shape):
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(2))


@pytest.mark.parametrize("maxdisp", [8, 16])
def test_plain_gwc_matches_pallas_kernel(rng, maxdisp):
    b, h, w, c, g = 2, 4, 24, 16, 4
    left, right = _features(rng, (b, h, w, c))
    want = np.asarray(_pallas_gwc_interpret(left, right, maxdisp, g))
    got = G.gwc_volume_reference(
        torch.from_numpy(left.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(right.transpose(0, 3, 1, 2).copy()), maxdisp, g,
    )
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 4, 1), want, atol=1e-5, rtol=0)


def test_dispatcher_takes_plain_version_on_cpu(rng):
    left, right = (torch.from_numpy(a) for a in _features(rng, (1, 16, 3, 10)))
    before = G.LAUNCHES
    got = G.gwc_volume(left, right, 12, 4)
    assert G.LAUNCHES == before
    torch.testing.assert_close(got, G.gwc_volume_reference(left, right, 12, 4), rtol=0, atol=0)


def test_plain_gwc_bf16_rounds_once(rng):
    """bf16 in: the sums run in f32 and round once, as the kernel does."""
    left, right = (torch.from_numpy(a).bfloat16() for a in _features(rng, (1, 16, 3, 10)))
    got = G.gwc_volume_reference(left, right, 6, 2)
    want = G.gwc_volume_reference(left.float(), right.float(), 6, 2).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "case,exc",
    [
        ("float64", TypeError),
        ("mixed_dtypes", TypeError),
        ("rank3", ValueError),
        ("shape_mismatch", ValueError),
        ("non_contiguous", ValueError),
        ("groups_do_not_divide", ValueError),
        ("unsupported_channels_per_group", ValueError),
        ("maxdisp_zero", ValueError),
        ("cpu_tensors", ValueError),
        ("empty_plane_range", ValueError),
        ("plane_range_past_maxdisp", ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(case, exc):
    x = torch.zeros(1, 16, 4, 8)
    args = {
        "float64": (x.double(), x.double(), 4, 4),
        "mixed_dtypes": (x, x.bfloat16(), 4, 4),
        "rank3": (x[0], x[0], 4, 4),
        "shape_mismatch": (x, torch.zeros(1, 16, 4, 9), 4, 4),
        "non_contiguous": (x.transpose(2, 3), x.transpose(2, 3), 4, 4),
        "groups_do_not_divide": (x, x, 4, 3),
        "unsupported_channels_per_group": (torch.zeros(1, 12, 4, 8), torch.zeros(1, 12, 4, 8), 4, 4),
        "maxdisp_zero": (x, x, 0, 4),
        "cpu_tensors": (x, x, 4, 4),
        "empty_plane_range": (x, x, 4, 4, (2, 2)),
        "plane_range_past_maxdisp": (x, x, 4, 4, (2, 5)),
    }[case]
    before = G.LAUNCHES
    with pytest.raises(exc):
        G.gwc_volume_cuda(*args)
    assert G.LAUNCHES == before


def test_import_needs_no_nvcc():
    """Importing the kernel module and taking the CPU path builds nothing."""
    code = (
        "import torch, dcanet_tpu_torch.kernels.gwc as G, dcanet_tpu_torch.kernels.build as B\n"
        "x = torch.ones(1, 8, 2, 5)\n"
        "assert G.gwc_volume(x, x, 3, 2).shape == (1, 2, 3, 2, 5)\n"
        "assert not B._loaded\n"
    )
    env = {**os.environ, "PATH": os.path.dirname(sys.executable), "CUDA_HOME": "/nonexistent"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


_TILE = re.compile(
    r"struct FwdTile<(float|__nv_bfloat16)> \{\s*"
    r"static constexpr int kTW = (\d+), kV = (\d+), kND = (\d+), kSlices = (\d+);"
)


def _forward_tiles():
    """(kTW, kV, kND, kSlices) of the forward kernel per element type, as csrc/gwc.cu sets them."""
    with open(os.path.join(REPO, "dcanet_tpu_torch", "csrc", "gwc.cu")) as f:
        tiles = {m.group(1): tuple(int(x) for x in m.groups()[1:]) for m in _TILE.finditer(f.read())}
    assert set(tiles) == {"float", "__nv_bfloat16"}, tiles
    return tiles


def _emulate_forward(left, right, maxdisp, groups, tw, v, nd, slices, d_lo=0):
    """The forward kernel of csrc/gwc.cu in numpy at f32: block by block
    (b, g, h, W-tile), pass by pass over d, the shared-memory tiles with
    their zero halo, and each thread's strip of R from which its window
    slides one column per d. `maxdisp` planes from disparity `d_lo` on: the
    passes start at d_lo rounded down to a multiple of kV, the planes below
    d_lo are not stored. Returns the volume (NaN where nothing was written)
    and the number of writes per element."""
    b_, c_, h_, w_ = left.shape
    cpg, ncg, dpass = c_ // groups, tw // v, slices * nd
    cg, s = (a.ravel() for a in np.meshgrid(np.arange(ncg), np.arange(slices), indexing="ij"))
    k, vv = np.arange(nd)[:, None], np.arange(v)[None, :]
    out = np.full((b_, groups, maxdisp, h_, w_), np.nan, np.float32)
    writes = np.zeros(out.shape, np.int64)
    off = d_lo % v
    dbase, total = d_lo - off, maxdisp + off

    def staged(rows, first, n):  # columns [first, first + n) of each row, zero outside [0, W)
        assert first % v == 0, f"a staged run at column {first} is not aligned to {v} (16-byte copies)"
        cols = first + np.arange(n)
        return np.where((cols >= 0) & (cols < w_), rows[:, np.clip(cols, 0, w_ - 1)], np.float32(0))

    for b in range(b_):
        for g in range(groups):
            chans = slice(g * cpg, (g + 1) * cpg)
            for h in range(h_):
                for w0 in range(0, w_, tw):
                    ls = staged(left[b, chans, h], w0, tw)  # (cpg, kTW)
                    for dc in range(0, total, dpass):
                        rs = staged(right[b, chans, h], w0 - dbase - dc - dpass, tw + dpass)
                        wv, d0 = w0 + cg * v, dc + s * nd
                        lwin = ls[:, (cg * v)[:, None] + np.arange(v)]  # (cpg, threads, kV)
                        strip = rs[:, (cg * v + dpass - (s + 1) * nd)[:, None] + np.arange(nd + v)]
                        rwin = strip[:, :, vv - k + nd]  # (cpg, threads, kND, kV): R[w - d]
                        acc = np.zeros(rwin.shape[1:], np.float32)
                        for c in range(cpg):
                            acc = acc + lwin[c][:, None, :] * rwin[c]
                        d = (d0[:, None, None] + k).repeat(v, 2)
                        w = (wv[:, None, None] + vv).repeat(nd, 1)
                        live = (wv < w_)[:, None, None] & (d0 < total)[:, None, None] & (d < total) & (d >= off)
                        live &= w < w_
                        val = np.where(w >= dbase + d, acc / np.float32(cpg), np.float32(0))
                        out[b, g, d[live] - off, h, w[live]] = val[live]
                        np.add.at(writes, (b, g, d[live] - off, h, w[live]), 1)
    return out, writes


@pytest.mark.parametrize("tile", ["float", "__nv_bfloat16"])
@pytest.mark.parametrize(
    "shape,groups,maxdisp",
    [
        ((1, 16, 2, 45), 4, 60),  # odd W (W % kV != 0, W < kTW), D = 60 > W
        ((2, 8, 2, 150), 8, 140),  # CPG = 1, W % kTW != 0, D > kTW: three passes over d
        ((1, 64, 1, 130), 2, 48),  # CPG = 32, W % kV != 0 on two tiles
        ((1, 32, 3, 24), 4, 8),  # D < one pass, W % kV == 0
    ],
)
def test_forward_index_map_emulation(tile, shape, groups, maxdisp):
    tw, v, nd, slices = _forward_tiles()[tile]
    rng = np.random.default_rng(5)
    left, right = _features(rng, shape)
    got, writes = _emulate_forward(left, right, maxdisp, groups, tw, v, nd, slices)
    assert (writes == 1).all(), f"{int((writes == 0).sum())} elements unwritten, {int((writes > 1).sum())} twice"
    want = G.gwc_volume_reference(torch.from_numpy(left), torch.from_numpy(right), maxdisp, groups)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("tile", ["float", "__nv_bfloat16"])
@pytest.mark.parametrize(
    "shape,groups,maxdisp,planes",
    [
        ((1, 32, 2, 64), 4, 48, (24, 48)),  # the second of 2 ranks at D = 48
        ((1, 16, 2, 45), 4, 60, (54, 60)),  # the last of 8 ranks at D = 60 (54 % kV != 0), past W = 45
        ((1, 16, 2, 72), 4, 60, (30, 38)),  # a middle rank at D = 60 (30 % kV != 0), inside W
        ((2, 8, 2, 150), 8, 140, (6, 130)),  # CPG = 1, several passes over d, D % pass != 0
        ((1, 32, 3, 24), 4, 8, (2, 6)),  # D < one pass
        # the disparity-sharded Middlebury train step's ranks (maxdisp 240,
        # W/4 = 176): 2 ranks (d_lo 30 % kV != 0) and 4 (16, 32, 46)
        *(((1, 16, 2, 176), 4, 60, planes) for planes in ((0, 30), (30, 60), (0, 16), (16, 32), (32, 46), (46, 60))),
    ],
)
def test_forward_plane_range_index_map_emulation(tile, shape, groups, maxdisp, planes):
    """A plane range: the kernel's passes start at d_lo, the staged window of
    R shifts with them, and the output holds planes - d_lo."""
    tw, v, nd, slices = _forward_tiles()[tile]
    rng = np.random.default_rng(6)
    left, right = _features(rng, shape)
    d_lo, d_hi = planes
    got, writes = _emulate_forward(left, right, d_hi - d_lo, groups, tw, v, nd, slices, d_lo=d_lo)
    assert (writes == 1).all(), f"{int((writes == 0).sum())} elements unwritten, {int((writes > 1).sum())} twice"
    want = G.gwc_volume_reference(torch.from_numpy(left), torch.from_numpy(right), maxdisp, groups, planes)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=0)


# every shape of the index-map emulation, and the main and train shapes cut in H
_CUDA_CASES = [
    ((2, 32, 6, 20), 4, 8), ((2, 32, 6, 20), 4, 12), ((2, 32, 6, 20), 4, 60),
    ((1, 16, 5, 45), 4, 60), ((2, 8, 2, 150), 8, 140), ((1, 64, 1, 130), 2, 48), ((1, 32, 3, 24), 4, 8),
    ((1, 320, 4, 312), 40, 48), ((1, 320, 4, 128), 40, 48),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    for shape, groups, maxdisp in _CUDA_CASES:
        left, right = (torch.from_numpy(a).cuda().to(dt) for a in _features(rng, shape))
        before = G.LAUNCHES
        got = G.gwc_volume(left, right, maxdisp, groups)
        assert G.LAUNCHES == before + 1
        want = G.gwc_volume_reference(left, right, maxdisp, groups)
        rtol = 0.0 if dt == torch.float32 else 2.0**-7
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_plane_ranges_match_plain_version(dtype):
    """Plane ranges (the disparity-sharded eval's and train step's), one
    launch each; the backward of a range, one launch of the range backward,
    against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    for shape, groups, maxdisp, planes in [((1, 320, 4, 256), 40, 48, (24, 48)), ((1, 16, 5, 45), 4, 60, (54, 60)),
                                           ((2, 8, 2, 150), 8, 140, (6, 130)), ((1, 32, 3, 24), 4, 8, (2, 6))]:
        left, right = (torch.from_numpy(a).cuda().to(dt) for a in _features(rng, shape))
        before = G.LAUNCHES
        got = G.gwc_volume(left, right, maxdisp, groups, planes)
        assert G.LAUNCHES == before + 1
        want = G.gwc_volume_reference(left, right, maxdisp, groups, planes)
        rtol = 0.0 if dt == torch.float32 else 2.0**-7
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)
        b, _, h, w = shape
        grad = torch.from_numpy(_occluded_nan_grad(rng, (b, groups, planes[1] - planes[0], h, w), planes[0]))
        grad = grad.cuda().to(dt)
        l, r = left.clone().requires_grad_(), right.clone().requires_grad_()
        before = (G.BACKWARD_LAUNCHES, G.RANGE_BACKWARD_LAUNCHES)
        G.gwc_volume(l, r, maxdisp, groups, planes).backward(grad)
        assert (G.BACKWARD_LAUNCHES, G.RANGE_BACKWARD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        want = G.gwc_volume_backward_reference(grad, left, right, maxdisp, groups, planes)
        for got, w_ in zip((l.grad, r.grad), want):
            atol = 1e-5 * max(1.0, float(w_.float().abs().max()))
            torch.testing.assert_close(got.float(), w_.float(), atol=atol, rtol=rtol)


# ---- backward ----

def _grad_case(rng, b=2, h=3, w=12, c=16, maxdisp=6, groups=4):
    left, right = _features(rng, (b, h, w, c))
    g = rng.standard_normal((b, maxdisp, h, w, groups), dtype=np.float32)  # JAX layout BDHWG
    return left, right, g, maxdisp, groups


def _port_grads(left, right, g, maxdisp, groups):
    """The port's differentiable gwc_volume on CPU tensors (NCHW / NCDHW)."""
    l = torch.from_numpy(left.transpose(0, 3, 1, 2).copy()).requires_grad_()
    r = torch.from_numpy(right.transpose(0, 3, 1, 2).copy()).requires_grad_()
    vol = G.gwc_volume(l, r, maxdisp, groups)
    vol.backward(torch.from_numpy(g.transpose(0, 4, 1, 2, 3).copy()))
    return l.grad.numpy().transpose(0, 2, 3, 1), r.grad.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("maxdisp", [6, 16])  # 16 > W: planes d >= W get no gradient
def test_gwc_grads_match_jax_grad(rng, maxdisp):
    """Port grads against jax.grad of the JAX package's build_gwc_volume."""
    import jax
    import jax.numpy as jnp
    from dcanet_tpu.ops.cost_volume import build_gwc_volume

    left, right, g, _, groups = _grad_case(rng, maxdisp=maxdisp)

    def loss(l, r):
        return jnp.sum(build_gwc_volume(l, r, maxdisp, groups) * g)

    want_dl, want_dr = jax.grad(loss, argnums=(0, 1))(jnp.asarray(left), jnp.asarray(right))
    dl, dr = _port_grads(left, right, g, maxdisp, groups)
    np.testing.assert_allclose(dl, np.asarray(want_dl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dr, np.asarray(want_dr), atol=1e-5, rtol=0)


def test_gwc_grads_match_pallas_custom_vjp_backward(rng):
    """Port grads against the JAX kernel's own backward, gwc.py::_bwd."""
    import jax.numpy as jnp
    from dcanet_tpu.kernels.gwc import _bwd

    left, right, g, maxdisp, groups = _grad_case(rng, maxdisp=8, groups=2)
    want_dl, want_dr = _bwd(maxdisp, groups, (jnp.asarray(left), jnp.asarray(right)), jnp.asarray(g))
    dl, dr = _port_grads(left, right, g, maxdisp, groups)
    np.testing.assert_allclose(dl, np.asarray(want_dl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dr, np.asarray(want_dr), atol=1e-5, rtol=0)


def test_plain_backward_is_autograd_of_plain_forward(rng):
    """gwc_volume_backward_reference (the kernel's plain version) is autograd
    through the plain forward, and builds no graph on its caller's tensors."""
    left, right, g, maxdisp, groups = _grad_case(rng)
    l, r = (torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in (left, right))
    gt = torch.from_numpy(g.transpose(0, 4, 1, 2, 3).copy())
    dl, dr = G.gwc_volume_backward_reference(gt, l, r, maxdisp, groups)
    assert not dl.requires_grad and dl.shape == l.shape and dr.shape == r.shape
    want_dl, want_dr = _port_grads(left, right, g, maxdisp, groups)
    np.testing.assert_allclose(dl.numpy().transpose(0, 2, 3, 1), want_dl, atol=0, rtol=0)
    np.testing.assert_allclose(dr.numpy().transpose(0, 2, 3, 1), want_dr, atol=0, rtol=0)


@pytest.mark.parametrize(
    "case", ["grad_shape", "grad_dtype", "grad_non_contiguous", "cpu_tensors"]
)
def test_backward_wrapper_rejects_bad_inputs(case):
    x = torch.zeros(1, 16, 4, 8)
    grad = torch.zeros(1, 4, 5, 4, 8)
    args = {
        "grad_shape": (torch.zeros(1, 4, 6, 4, 8), x, x),
        "grad_dtype": (grad.double(), x, x),
        "grad_non_contiguous": (torch.zeros(1, 4, 5, 8, 4).transpose(3, 4), x, x),
        "cpu_tensors": (grad, x, x),
    }[case]
    before = G.BACKWARD_LAUNCHES
    with pytest.raises(ValueError):
        G.gwc_volume_backward_cuda(*args, 5, 4)
    assert G.BACKWARD_LAUNCHES == before


_BWD_TILE = re.compile(
    r"struct BwdTile<(float|__nv_bfloat16)> \{\s*"
    r"static constexpr int kTW = (\d+), kV = (\d+), kND = (\d+), kCH = (\d+), kSplit = (\d+), "
    r"kPass = (\d+), kHalo = (\d+);"
)


def _backward_tiles():
    """(kTW, kV, kND, kCH, kSplit, kPass, kHalo) of the backward kernel per
    element type, as csrc/gwc.cu sets them."""
    with open(os.path.join(REPO, "dcanet_tpu_torch", "csrc", "gwc.cu")) as f:
        tiles = {m.group(1): tuple(int(x) for x in m.groups()[1:]) for m in _BWD_TILE.finditer(f.read())}
    assert set(tiles) == {"float", "__nv_bfloat16"}, tiles
    return tiles


def _occluded_nan_grad(rng, shape, d_lo=0):
    """A volume grad (B, G, D, H, W) of the planes from d_lo on with NaN at
    the occluded entries w < d, which must reach neither dL nor dR."""
    grad = rng.standard_normal(shape, dtype=np.float32)
    d, w = d_lo + np.arange(shape[2])[:, None, None], np.arange(shape[4])[None, None, :]
    return np.where(w < d, np.float32(np.nan), grad)


def _backward_tile_width(w, ktw):
    """csrc/gwc.cu's bwd_tile_width: kTW columns per item, or kTW / 2 where its
    tiles leave fewer columns of a row of w idle."""
    half = ktw // 2
    return half if -(-w // half) * half < -(-w // ktw) * ktw else ktw


def _backward_split(cpg, tw, v, kch, ksplit):
    """csrc/gwc.cu's bwd_split: kSplit threads per set of sums, or 1 where the
    block would pass 512 threads."""
    sums = tw // v * (cpg // min(cpg, kch))
    return ksplit if 2 * sums * ksplit <= 512 else 1


def _backward_phases(maxdisp, nd, kpass, khalo, dbase=0):
    """csrc/gwc.cu's BwdPlan over `maxdisp` rows from disparity dbase: the
    halo, and per phase (dc, rows, dL?, dR?, a)."""
    up = lambda x: -(-x // nd) * nd  # noqa: E731
    halo = min(up(maxdisp), khalo)
    dpass = min(kpass, halo)
    passes = -(-maxdisp // dpass)
    rows = lambda dc: min(dpass, up(maxdisp - dc))  # noqa: E731
    full = halo // dpass
    joint = min(passes, full) + (passes > full and full * dpass + rows(full * dpass) <= halo)
    joint = 0 if dbase else joint
    out = [(p * dpass, rows(p * dpass), True, True, 0) for p in range(joint)]
    for p in range(joint, passes):
        out += [(p * dpass, rows(p * dpass), True, False, 0),
                (p * dpass, rows(p * dpass), False, True, dbase + p * dpass)]
    return halo, dpass, out


def _emulate_backward(grad, left, right, maxdisp, groups, tw, v, nd, kch, split, kpass, khalo, d_lo=0):
    """The backward kernel of csrc/gwc.cu in numpy at f32: item by item
    (b, g, h, W-tile), phase by phase (the passes that fit the window for dL
    and dR, every later pass once for dL and once for dR), the shared-memory
    windows with their zero halo and zero rows from D on (NaN where a phase
    stages nothing; for dL the occluded Gv[d, u < d] zeroed: whole vectors
    at staging, the rest after), and each set of sums's steps of kND
    disparities, step j taken by its thread j % kSplit: the kND x kV values
    of Gv (dR: the diagonal, from the aligned loads the kernel makes) and
    the strips of R or L. Every shared read is checked to lie inside its
    window; the first thread of a set adds the others' sums and writes.
    With d_lo > 0, `grad` holds the planes [d_lo, d_lo + D) alone: the
    passes cover the rows from dbase = d_lo rounded down to kND, those
    below d_lo staged as zeros, in absolute disparities dbase + row.
    Returns (dL, dR), NaN where nothing was written, and the number of
    writes per element of each."""
    b_, c_, h_, w_ = left.shape
    cpg = c_ // groups
    ch = min(cpg, kch)
    n_planes = grad.shape[2]
    off = d_lo % nd
    dbase, rows_total = d_lo - off, n_planes + off  # the rows the passes cover
    assert d_lo + n_planes <= maxdisp
    halo, dpass, phases = _backward_phases(rows_total, nd, kpass, khalo, dbase)
    pitch = tw + halo
    q, s = (a.ravel() for a in np.meshgrid(np.arange(tw // v), np.arange(cpg // ch), indexing="ij"))
    c0 = s * ch
    k, vv = np.arange(nd)[:, None], np.arange(v)[None, :]
    outs = (np.full(left.shape, np.nan, np.float32), np.full(left.shape, np.nan, np.float32))
    writes = (np.zeros(left.shape, np.int64), np.zeros(left.shape, np.int64))

    def staged(rows, first, n):  # columns [first, first + n) of each row, zero outside [0, W)
        cols = first + np.arange(n)
        return np.where((cols >= 0) & (cols < w_), rows[..., np.clip(cols, 0, w_ - 1)], np.float32(0))

    def read(win, rows, cols):  # shared loads, each inside the staged window
        assert cols.min() >= 0 and cols.max() < pitch and rows.min() >= 0 and rows.max() < win.shape[0]
        return win[rows, cols]

    for b in range(b_):
        for g in range(groups):
            chans = slice(g * cpg, (g + 1) * cpg)
            for h in range(h_):
                for w0 in range(0, w_, tw):
                    w = w0 + q * v  # each thread's first column
                    acc = np.zeros((2, split, len(q), ch, v), np.float32)  # [dL, dR][thread of the set]
                    for dc, rows, do_dl, do_dr, a in phases:
                        dca = dbase + dc  # the disparity of the phase's first row
                        gcols = tw + dca - a + rows if do_dr else tw
                        gs = np.full((dpass, pitch), np.nan, np.float32)  # stale where nothing is staged
                        d = dc + np.arange(rows)
                        live = (d >= off) & (d < rows_total)
                        gv = np.where(live[:, None], grad[b, g, np.clip(d - off, 0, n_planes - 1), h], 0)
                        gs[:rows, :gcols] = staged(gv, w0 + a, gcols)
                        if do_dl:  # the occluded Gv[d, u < d]: whole vectors zero at staging, the rest after
                            occluded = (dbase + d - w0)[:, None]
                            col = np.arange(gcols)[None, :]
                            gs[:rows, :gcols][(col - col % v + v <= occluded)] = 0
                            gs[:rows, :gcols][(col < occluded) & (occluded < tw)] = 0
                        rs, ls = np.full((2, cpg, pitch), np.nan, np.float32)
                        if do_dl:
                            rs = np.full((cpg, pitch), np.nan, np.float32)
                            rs[:, : tw + rows] = staged(right[b, chans, h], w0 - dca - rows, tw + rows)
                        if do_dr:
                            ls = np.full((cpg, pitch), np.nan, np.float32)
                            ls[:, : tw + rows] = staged(left[b, chans, h], w0 + dca, tw + rows)
                        for j in range(rows // nd):
                            d0 = dc + j * nd
                            cs = (c0[:, None] + np.arange(ch))[:, :, None]  # (threads, kCh, 1)
                            if do_dl:  # dL(c, w + v) += Gv[d0 + k, w + v] R[c, w + v - dbase - d0 - k]
                                on = (w < w_) & (d0 < rows_total) & (dbase + d0 < w + v)
                                gval = read(gs, (j * nd + k)[None], (q * v)[:, None, None] + vv)
                                strip = read(rs, cs, (q * v + rows - (j + 1) * nd)[:, None, None] + np.arange(nd + v))
                                terms = gval[:, None] * strip[:, :, vv - k + nd]  # (threads, kCh, kND, kV)
                                acc[0, j % split][on] += terms[on].sum(axis=2)
                            if do_dr:  # dR(c, w + v) += Gv[d0 + k, w + v + e0 + k] L[c, w + v + e0 + k]
                                e0 = dbase + d0
                                on = (w < w_) & (d0 < rows_total) & (w + e0 < w_)
                                base = (q * v + e0 - a)[:, None, None] + (k - k % v)  # aligned loads
                                width = np.where(k % v == 0, v, 2 * v)
                                read(gs, (j * nd + k)[None], base + width - 1)
                                gval = read(gs, (j * nd + k)[None], base + k % v + vv)
                                strip = read(ls, cs, (q * v + j * nd)[:, None, None] + np.arange(nd + v))
                                terms = gval[:, None] * strip[:, :, k + vv]
                                acc[1, j % split][on] += terms[on].sum(axis=2)
                    for out, count, a_ in zip(outs, writes, acc.sum(axis=1)):
                        for t in np.flatnonzero(w < w_):
                            cols = w[t] + np.arange(v)
                            live = cols < w_
                            cidx = g * cpg + c0[t] + np.arange(ch)
                            out[b, cidx[:, None], h, cols[live][None]] = a_[t][:, live] / np.float32(cpg)
                            count[b, cidx[:, None], h, cols[live][None]] += 1
    return outs, writes


@pytest.mark.parametrize("tile", ["float", "__nv_bfloat16"])
@pytest.mark.parametrize(
    "shape,groups,maxdisp",
    [
        ((1, 16, 2, 45), 4, 60),  # odd W (W % kV != 0, W < kTW), D = 60 > W
        ((2, 8, 2, 150), 8, 140),  # CPG = 1, D > kHalo: three passes, the later ones split into dL and dR
        ((1, 64, 1, 130), 2, 48),  # CPG = 32, W % kV != 0 on two tiles
        ((1, 32, 3, 24), 4, 8),  # D < one step of some threads' loops, W % kV == 0
        ((1, 16, 2, 176), 4, 60),  # the Middlebury width: three items of kTW / 2, Gv's halo from the next
        ((1, 16, 1, 256), 4, 60),  # two items of kTW
        ((1, 64, 1, 128), 2, 48),  # CPG = 32 on one full tile (f32: one thread per set of sums)
        ((1, 32, 1, 256), 2, 48),  # CPG = 16 on two full tiles
        ((2, 8, 1, 100), 4, 48),  # CPG = 2
    ],
)
def test_backward_index_map_emulation(tile, shape, groups, maxdisp):
    """Integer-valued inputs: every sum is exact in f32 whatever its order, so
    the emulation and the plain version agree to rounding of the last
    division alone (cpg is a power of two: none)."""
    ktw, v, nd, kch, ksplit, kpass, khalo = _backward_tiles()[tile]
    tw = _backward_tile_width(shape[3], ktw)
    split = _backward_split(shape[1] // groups, tw, v, kch, ksplit)
    rng = np.random.default_rng(6)
    left, right = (rng.integers(-4, 5, shape).astype(np.float32) for _ in range(2))
    b, _, h, w = shape
    grad = np.round(_occluded_nan_grad(rng, (b, groups, maxdisp, h, w)) * 2)
    (dl, dr), (nl, nr) = _emulate_backward(grad, left, right, maxdisp, groups, tw, v, nd, kch, split, kpass, khalo)
    for n in (nl, nr):
        assert (n == 1).all(), f"{int((n == 0).sum())} elements unwritten, {int((n > 1).sum())} more than once"
    want = G.gwc_volume_backward_reference(
        torch.from_numpy(grad), torch.from_numpy(left), torch.from_numpy(right), maxdisp, groups
    )
    np.testing.assert_allclose(dl, want[0].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dr, want[1].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("tile", ["float", "__nv_bfloat16"])
@pytest.mark.parametrize(
    "shape,groups,maxdisp,planes",
    [
        ((1, 16, 2, 128), 4, 48, (0, 24)),  # the train shape's two ranks, cut in C and H
        ((1, 16, 2, 128), 4, 48, (24, 48)),
        ((1, 16, 2, 128), 4, 48, (16, 32)),  # a middle rank of three
        ((1, 16, 2, 176), 4, 60, (54, 60)),  # the Middlebury width, the last of 8 ranks: d_lo % kND != 0
        ((1, 16, 2, 176), 4, 60, (0, 8)),
        ((1, 16, 2, 45), 4, 60, (6, 58)),  # odd W, a range that starts inside a step and passes W
        ((2, 8, 2, 150), 8, 140, (10, 130)),  # CPG = 1, more rows than the halo: several split passes
        ((1, 64, 1, 130), 2, 48, (40, 48)),  # CPG = 32 on two tiles
        ((2, 16, 3, 7), 4, 12, (8, 12)),  # every plane at or past W
        # the disparity-sharded Middlebury train step's ranks (maxdisp 240,
        # W/4 = 176): 2 ranks (d_lo 30 % kND != 0) and 4 (16, 32, 46)
        *(((1, 16, 2, 176), 4, 60, planes) for planes in ((0, 30), (30, 60), (0, 16), (16, 32), (32, 46), (46, 60))),
    ],
)
def test_backward_plane_range_index_map_emulation(tile, shape, groups, maxdisp, planes):
    """The backward kernel over the planes [d_lo, d_hi): every output element
    written once, equal to the plain version's range backward (integer
    inputs, as above)."""
    ktw, v, nd, kch, ksplit, kpass, khalo = _backward_tiles()[tile]
    tw = _backward_tile_width(shape[3], ktw)
    split = _backward_split(shape[1] // groups, tw, v, kch, ksplit)
    rng = np.random.default_rng(7)
    left, right = (rng.integers(-4, 5, shape).astype(np.float32) for _ in range(2))
    b, _, h, w = shape
    d_lo, d_hi = planes
    grad = np.round(_occluded_nan_grad(rng, (b, groups, d_hi - d_lo, h, w), d_lo) * 2)
    (dl, dr), (nl, nr) = _emulate_backward(grad, left, right, maxdisp, groups, tw, v, nd, kch, split, kpass, khalo,
                                           d_lo)
    for n in (nl, nr):
        assert (n == 1).all(), f"{int((n == 0).sum())} elements unwritten, {int((n > 1).sum())} more than once"
    want = G.gwc_volume_backward_reference(
        torch.from_numpy(grad), torch.from_numpy(left), torch.from_numpy(right), maxdisp, groups, planes
    )
    np.testing.assert_allclose(dl, want[0].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dr, want[1].numpy(), atol=1e-6, rtol=0)


# the emulation's shapes, 2 and 16 channels per group, and the train and
# Middlebury shapes cut in H
_CUDA_BWD_CASES = [
    ((2, 32, 6, 20), 4, 8), ((2, 32, 6, 20), 4, 12), ((2, 32, 6, 20), 4, 60),
    ((1, 16, 2, 45), 4, 60), ((2, 8, 2, 150), 8, 140), ((1, 64, 1, 130), 2, 48), ((1, 64, 2, 128), 2, 48),
    ((1, 32, 1, 256), 2, 48), ((2, 8, 3, 100), 4, 48), ((1, 32, 3, 24), 4, 8), ((1, 16, 2, 176), 4, 60),
    ((1, 320, 4, 128), 40, 48), ((1, 320, 4, 176), 40, 60),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    for shape, groups, maxdisp in _CUDA_BWD_CASES:
        b, _, h, w = shape
        left, right = (torch.from_numpy(a).cuda().to(dt) for a in _features(rng, shape))
        grad = torch.from_numpy(_occluded_nan_grad(rng, (b, groups, maxdisp, h, w))).cuda().to(dt)
        l, r = left.clone().requires_grad_(), right.clone().requires_grad_()
        before = G.BACKWARD_LAUNCHES
        G.gwc_volume(l, r, maxdisp, groups).backward(grad)
        assert G.BACKWARD_LAUNCHES == before + 1
        want = G.gwc_volume_backward_reference(grad, left, right, maxdisp, groups)
        rtol = 0.0 if dt == torch.float32 else 2.0**-7
        for got, w_ in zip((l.grad, r.grad), want):
            # f32: sums of up to D products in another order (no mean over
            # the channels where one channel makes a group), so the tolerance
            # scales with the output's magnitude, as chip_smoke.py's does
            atol = 1e-5 * max(1.0, float(w_.float().abs().max()))
            torch.testing.assert_close(got.float(), w_.float(), atol=atol, rtol=rtol)
