"""The gwc cost-volume kernel module of the port (dcanet_tpu_torch.kernels.gwc).

On the CPU: the plain version against the JAX package's Pallas kernel run in
interpret mode, the dispatcher's CPU path, and the wrapper's input checks.
The CUDA kernel itself is compared with its plain version by the card-only
test below and by chip_smoke.py. The card's machine has no JAX, so JAX is
imported inside the one test that needs it and the card-only test uses no
fixture of tests/conftest.py; there, run:
    python -m pytest --noconftest -m cuda tests/test_torch_gwc.py
"""

import functools
import os
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    left, right = (torch.from_numpy(a).cuda().to(dt) for a in _features(rng, (2, 32, 6, 20)))
    for maxdisp in (8, 12, 60):
        before = G.LAUNCHES
        got = G.gwc_volume(left, right, maxdisp, 4)
        assert G.LAUNCHES == before + 1
        want = G.gwc_volume_reference(left, right, maxdisp, 4)
        rtol = 0.0 if dt == torch.float32 else 2.0**-7
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    left, right = (torch.from_numpy(a).cuda().to(dt) for a in _features(rng, (2, 32, 6, 20)))
    for maxdisp in (8, 12, 60):
        grad = torch.from_numpy(rng.standard_normal((2, 4, maxdisp, 6, 20), dtype=np.float32)).cuda().to(dt)
        l, r = left.clone().requires_grad_(), right.clone().requires_grad_()
        before = G.BACKWARD_LAUNCHES
        G.gwc_volume(l, r, maxdisp, 4).backward(grad)
        assert G.BACKWARD_LAUNCHES == before + 1
        want = G.gwc_volume_backward_reference(grad, left, right, maxdisp, 4)
        rtol = 0.0 if dt == torch.float32 else 2.0**-7
        for got, w in zip((l.grad, r.grad), want):
            torch.testing.assert_close(got.float(), w.float(), atol=1e-5, rtol=rtol)
