"""The conv3d kernel module of the port (dcanet_tpu_torch.kernels.conv3d).

On the CPU: the plain version against the JAX package's Pallas kernel
(`conv3d_pallas`) run in interpret mode, with and without the scale, bias
and ReLU epilogue; the port's `conv3d_fast` grads against `jax.grad` of the
JAX package's `conv3d_fast` custom_vjp in interpret mode; the dispatcher's
CPU path and the wrapper's input checks. Tolerance 1e-4: float32 sums of
27*C products in another order (the JAX side measured 4.8e-6 forward and
3.3e-6 dx against XLA's conv at these sizes).
The CUDA kernel itself is compared with its plain version by the card-only
test below and by chip_smoke.py; there, run
    python -m pytest --noconftest -m cuda tests/test_torch_conv3d.py
"""

import numpy as np
import pytest
import torch

import dcanet_tpu_torch.kernels.conv3d as CV

torch.set_num_threads(2)

B, D, H, W, C, CO = 1, 3, 8, 10, 8, 16


def _interpret(fn, *args, **kw):
    import dcanet_tpu.kernels.conv3d as K

    K._INTERPRET = True
    try:
        return fn(*args, **kw)
    finally:
        K._INTERPRET = False


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)  # NDHWC
    w = (rng.standard_normal((3, 3, 3, C, CO)) * 0.2).astype(np.float32)  # DHWIO
    scale = rng.uniform(0.5, 1.5, CO).astype(np.float32)
    bias = rng.normal(0.0, 0.1, CO).astype(np.float32)
    return x, w, scale, bias


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def _oidhw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def _ndhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 4, 1)


@pytest.mark.parametrize("epilogue", ["none", "scale_bias", "scale_bias_relu"])
def test_plain_conv3d_matches_pallas_kernel(epilogue):
    import jax.numpy as jnp
    from dcanet_tpu.kernels.conv3d import conv3d_pallas

    x, w, scale, bias = _inputs(0)
    affine = epilogue != "none"
    relu = epilogue == "scale_bias_relu"
    kw = dict(scale=jnp.asarray(scale), bias=jnp.asarray(bias)) if affine else {}
    want = np.asarray(_interpret(conv3d_pallas, jnp.asarray(x), jnp.asarray(w), relu=relu, **kw))
    got = CV.conv3d_reference(
        _ncdhw(x), _oidhw(w), torch.from_numpy(scale) if affine else None,
        torch.from_numpy(bias) if affine else None, relu=relu,
    )
    assert got.shape == (B, CO, D, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(_ndhwc(got), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("relu", [False, True])
def test_conv3d_fast_grads_match_jax(relu):
    import jax
    import jax.numpy as jnp
    from dcanet_tpu.kernels.conv3d import conv3d_fast

    x, w, _, _ = _inputs(1)
    g = np.random.default_rng(2).standard_normal((B, D, H, W, CO)).astype(np.float32)

    def loss(xj, wj):
        return jnp.sum(conv3d_fast(xj, wj, relu) * g)

    want_y = np.asarray(_interpret(conv3d_fast, jnp.asarray(x), jnp.asarray(w), relu))
    want_dx, want_dw = _interpret(jax.grad(loss, argnums=(0, 1)), jnp.asarray(x), jnp.asarray(w))

    xt, wt = _ncdhw(x).requires_grad_(), _oidhw(w).requires_grad_()
    before = CV.LAUNCHES
    y = CV.conv3d_fast(xt, wt, relu)
    (y * _ncdhw(g)).sum().backward()
    assert CV.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_allclose(_ndhwc(y), want_y, atol=1e-4, rtol=0)
    np.testing.assert_allclose(_ndhwc(xt.grad), np.asarray(want_dx), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        wt.grad.numpy().transpose(2, 3, 4, 1, 0), np.asarray(want_dw), atol=1e-4, rtol=0
    )


def test_conv3d_fast_matches_autograd_of_plain_version():
    """The hand-written backward (flipped, transposed weight for dgrad;
    library wgrad) against autograd through the plain version."""
    x, w, _, _ = _inputs(3)
    xt, wt = _ncdhw(x).requires_grad_(), _oidhw(w).requires_grad_()
    g = torch.randn(B, CO, D, H, W, generator=torch.Generator().manual_seed(4))
    dx, dw = torch.autograd.grad(CV.conv3d_fast(xt, wt, True), (xt, wt), g)
    dx_ref, dw_ref = torch.autograd.grad(CV.conv3d_reference(xt, wt, relu=True), (xt, wt), g)
    torch.testing.assert_close(dx, dx_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(dw, dw_ref, atol=1e-4, rtol=0)


def test_plain_conv3d_bf16_rounds_once():
    """bf16 in: the sums run in f32 and round once, as the kernel does."""
    x, w, scale, bias = _inputs(5)
    xb, wb = _ncdhw(x).bfloat16(), _oidhw(w).bfloat16()
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    got = CV.conv3d_reference(xb, wb, sc, bi, relu=True)
    want = CV.conv3d_reference(xb.float(), wb.float(), sc, bi, relu=True).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dispatcher_takes_plain_version_on_cpu():
    x, w, scale, bias = _inputs(6)
    before = CV.LAUNCHES
    got = CV.conv3d(_ncdhw(x), _oidhw(w), torch.from_numpy(scale), torch.from_numpy(bias), relu=True)
    assert CV.LAUNCHES == before
    want = CV.conv3d_reference(_ncdhw(x), _oidhw(w), torch.from_numpy(scale), torch.from_numpy(bias), relu=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "case,exc",
    [
        ("float64", TypeError),
        ("mixed_dtypes", TypeError),
        ("rank4", ValueError),
        ("kernel_not_3x3x3", ValueError),
        ("channel_mismatch", ValueError),
        ("non_contiguous", ValueError),
        ("bad_scale", ValueError),
        ("cpu_tensors", ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(case, exc):
    x = torch.zeros(1, 4, 3, 5, 6)
    w = torch.zeros(8, 4, 3, 3, 3)
    args = {
        "float64": (x.double(), w.double()),
        "mixed_dtypes": (x, w.bfloat16()),
        "rank4": (x[0], w),
        "kernel_not_3x3x3": (x, torch.zeros(8, 4, 1, 3, 3)),
        "channel_mismatch": (x, torch.zeros(8, 5, 3, 3, 3)),
        "non_contiguous": (x.transpose(3, 4), w),
        "bad_scale": (x, w, torch.ones(7)),
        "cpu_tensors": (x, w),
    }[case]
    before = CV.LAUNCHES
    with pytest.raises(exc):
        CV.conv3d_cuda(*args)
    assert CV.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    for shape, co in (((2, 5, 3, 9, 33), 40), ((1, 32, 4, 16, 40), 32)):
        x = torch.randn(shape, generator=gen).cuda().to(dt)
        w = (torch.randn((co, shape[1], 3, 3, 3), generator=gen) * 0.1).cuda().to(dt)
        sc = (torch.rand(co, generator=gen) + 0.5).cuda()
        bi = (torch.randn(co, generator=gen) * 0.1).cuda()
        before = CV.LAUNCHES
        got = CV.conv3d(x, w, sc, bi, relu=True)
        assert CV.LAUNCHES == before + 1
        want = CV.conv3d_reference(x, w, sc, bi, relu=True)
        rtol = 0.0 if dt == torch.float32 else 2.0**-7
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=rtol)
