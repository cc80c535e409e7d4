"""The conv3d kernel module of the port (dcanet_tpu_torch.kernels.conv3d).

On the CPU: the plain version against the JAX package's Pallas kernel
(`conv3d_pallas`) run in interpret mode, with and without the scale, bias
and ReLU epilogue; the port's `conv3d_fast` grads against `jax.grad` of the
JAX package's `conv3d_fast` custom_vjp in interpret mode; the dispatcher's
CPU path and the wrapper's input checks. Tolerance 1e-4: float32 sums of
27*C products in another order (the JAX side measured 4.8e-6 forward and
3.3e-6 dx against XLA's conv at these sizes).
The f32 and bf16 kernels' loops over their packed weights are emulated in
plain torch against the plain version (the f32 one at the f32 tolerance,
and with one TF32 pass, which misses it). The CUDA kernels themselves are
compared with the plain version by the card-only tests below and by
chip_smoke.py; there, run
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


def _emulate_bf16_kernel(x, wp, co, scale, bias, relu):
    """The bf16 tensor-core kernel's loop, in plain torch: per output-channel
    tile, kd plane, 16-channel chunk and (kh, kw) tap, one (pixels x 16) x
    (16 x 32) product of bf16 values over the packed, zero-padded weights,
    accumulated in f32; then scale, bias, ReLU and one rounding to bf16."""
    b, c, d, h, wd = x.shape
    ct, _, cc, _, cot, ck = wp.shape
    xp = torch.nn.functional.pad(x.float(), (1, 1, 1, 1, 1, 1, 0, cc * ck - c))  # channels zero-padded too
    acc = torch.zeros(b, ct * cot, d, h, wd)
    for t in range(ct):
        for kd in range(3):
            for ci in range(cc):
                for tap in range(9):
                    kh, kw = divmod(tap, 3)
                    a = xp[:, ci * ck : (ci + 1) * ck, kd : kd + d, kh : kh + h, kw : kw + wd]
                    acc[:, t * cot : (t + 1) * cot] += torch.einsum("bcdhw,oc->bodhw", a, wp[t, kd, ci, tap].float())
    y = acc[:, :co] * scale.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1)
    return (torch.relu(y) if relu else y).bfloat16()


@pytest.mark.parametrize("c,co", [(5, 40), (32, 32), (64, 32)])
def test_bf16_kernel_loop_over_packed_weights_matches_plain_version(c, co):
    """The packing (`pack_weight_bf16`) and the kernel's step/tap loop over it
    give the plain conv: catches padding and index mistakes without a card.
    Both sum bf16 products in f32 and round once, in another order: one bf16
    ulp (2^-7 relative) on top of 1e-5 * max(1, max|ref|)."""
    rng = np.random.default_rng(7 + c)
    x = torch.from_numpy(rng.standard_normal((1, c, 3, 5, 7)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((co, c, 3, 3, 3)) * 0.1).astype(np.float32)).bfloat16()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.1, co).astype(np.float32))
    wp = CV.pack_weight_bf16(w)
    assert wp.shape == (-(-co // 32), 3, -(-c // 16), 9, 32, 16) and wp.dtype == torch.bfloat16
    pad = torch.zeros(wp.numel() - w.numel())  # every weight once, zeros elsewhere
    assert torch.equal(wp.flatten().float().sort().values, torch.cat([w.flatten().float(), pad]).sort().values)
    got = _emulate_bf16_kernel(x, wp, co, scale, bias, relu=True)
    want = CV.conv3d_reference(x, w, scale, bias, relu=True)
    atol = 1e-5 * max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=2.0**-7)


def test_pack_weight_bf16_places_each_weight():
    """wp[co // 32, kd, c // 16, 3 kh + kw, co % 32, c % 16] = w[co, c, kd, kh, kw]
    (distinct f32 values, so each lands in exactly one place)."""
    co, c = 40, 20
    w = torch.arange(1, co * c * 27 + 1, dtype=torch.float32).view(co, c, 3, 3, 3)
    wp = CV.pack_weight_bf16(w)
    for o, i, kd, kh, kw in [(0, 0, 0, 0, 0), (39, 19, 2, 2, 2), (33, 17, 1, 0, 2), (5, 16, 2, 1, 0)]:
        assert wp[o // 32, kd, i // 16, 3 * kh + kw, o % 32, i % 16] == w[o, i, kd, kh, kw]
    assert float(wp[1, :, :, :, co - 32 :].float().abs().sum()) == 0.0  # Co padding
    assert float(wp[:, :, 1, :, :, c - 16 :].float().abs().sum()) == 0.0  # C padding


def test_round_tf32_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero, low 13 bits
    zero; inf and nan unchanged."""
    u = 2.0**-10  # TF32 ulp at 1
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 2 - 2.0**-23, 1 + 1.5 * u, 3.0, 0.0,
                      float("inf"), float("-inf")])
    want = torch.tensor([1 + u, -(1 + u), 1.0, 1 + 2 * u, 3.0, 0.0, float("inf"), float("-inf")])
    got = CV.round_tf32(x)
    assert torch.equal(got, want)
    assert bool(torch.isnan(CV.round_tf32(torch.tensor([float("nan")]))).all())
    r = CV.round_tf32(torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 100)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_pack_weight_tf32x3_places_each_weight_once():
    """wp[co // 32, kd, c // 8, part, 3 kh + kw, co % 32, c % 8]: part 0 is
    hi, part 1 lo, both TF32 (low 13 bits zero); hi + lo = w within 2^-21
    relative; the Co and C padding is zero."""
    co, c = 40, 12
    rng = np.random.default_rng(11)
    w = torch.from_numpy((rng.standard_normal((co, c, 3, 3, 3)) * 0.1).astype(np.float32))
    wp = CV.pack_weight_tf32x3(w)
    assert wp.shape == (2, 3, 2, 2, 9, 32, 8) and wp.dtype == torch.float32
    assert int((wp.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    hi, lo = wp[:, :, :, 0], wp[:, :, :, 1]  # (ct, 3, cc, 9, 32, 8)
    # back to (Co', C', 3, 3, 3)
    back = (hi + lo).permute(0, 4, 2, 5, 1, 3).reshape(64, 16, 3, 3, 3)
    assert float(back[co:].abs().sum()) == 0.0 and float(back[:, c:].abs().sum()) == 0.0
    assert bool(((back[:co, :c] - w).abs() <= 2.0**-21 * w.abs()).all())
    assert torch.equal(hi.permute(0, 4, 2, 5, 1, 3).reshape(64, 16, 3, 3, 3)[:co, :c], CV.round_tf32(w))
    assert bool((lo.abs() <= 2.0**-11 * hi.abs()).all())
    for o, i, kd, kh, kw in [(0, 0, 0, 0, 0), (39, 11, 2, 2, 2), (33, 9, 1, 0, 2), (5, 8, 2, 1, 0)]:
        v = wp[o // 32, kd, i // 8, :, 3 * kh + kw, o % 32, i % 8]
        assert v[0] == CV.round_tf32(w[o, i, kd, kh, kw]) and abs(float(v.sum() - w[o, i, kd, kh, kw])) <= 1e-8


def _truncate_tf32(t):
    """The top 19 bits of each f32 (sign, exponent, 10 mantissa bits)."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _emulate_tf32x3_kernel(x, wp, co, scale, bias, relu, passes=3):
    """The f32 kernel's loop, in plain torch: per output-channel tile, kd
    plane and 8-channel chunk (a step), and (kh, kw) tap, the input split
    into TF32 halves as the kernel splits its A fragments (hi truncated, lo
    = x - hi, of which the MMA reads the top 19 bits) and the packed
    weight's halves, lo*hi + hi*lo + hi*hi (or hi*hi alone, passes=1) summed
    in f32 into the step's partial sum, which is added to the running sum;
    then scale, bias and ReLU."""
    b, c, d, h, wd = x.shape
    ct, _, cc, _, _, cot, ck = wp.shape
    xp = torch.nn.functional.pad(x.float(), (1, 1, 1, 1, 1, 1, 0, cc * ck - c))  # channels zero-padded too
    x_hi = _truncate_tf32(xp)
    x_lo = _truncate_tf32(xp - x_hi)
    acc = torch.zeros(b, ct * cot, d, h, wd)
    for t in range(ct):
        for kd in range(3):
            for ci in range(cc):
                part = torch.zeros(b, cot, d, h, wd)
                for tap in range(9):
                    kh, kw = divmod(tap, 3)
                    win = (slice(None), slice(ci * ck, (ci + 1) * ck), slice(kd, kd + d), slice(kh, kh + h),
                           slice(kw, kw + wd))
                    w_hi, w_lo = wp[t, kd, ci, 0, tap], wp[t, kd, ci, 1, tap]
                    if passes == 3:
                        part += torch.einsum("bcdhw,oc->bodhw", x_lo[win], w_hi)
                        part += torch.einsum("bcdhw,oc->bodhw", x_hi[win], w_lo)
                    part += torch.einsum("bcdhw,oc->bodhw", x_hi[win], w_hi)
                acc[:, t * cot : (t + 1) * cot] += part
    y = acc[:, :co] * scale.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1)
    return torch.relu(y) if relu else y


def _f32_case(c, co):
    rng = np.random.default_rng(17 + c)
    x = torch.from_numpy(rng.standard_normal((1, c, 3, 5, 7)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((co, c, 3, 3, 3)) * 0.1).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.1, co).astype(np.float32))
    want = CV.conv3d_reference(x, w, scale, bias, relu=True)
    return x, w, scale, bias, want, 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("c,co", [(5, 40), (32, 32), (64, 32)])
def test_tf32x3_kernel_loop_over_packed_weights_matches_plain_version(c, co):
    """The f32 kernel's three TF32 passes over `pack_weight_tf32x3`'s layout
    give the plain f32 conv within the f32 tolerance, 1e-5 * max(1, max|ref|)
    (as chip_smoke.py holds the kernel to): catches packing, index and
    split mistakes without a card."""
    x, w, scale, bias, want, atol = _f32_case(c, co)
    got = _emulate_tf32x3_kernel(x, CV.pack_weight_tf32x3(w), co, scale, bias, relu=True)
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("c,co", [(5, 40), (32, 32), (64, 32)])
def test_one_tf32_pass_misses_the_f32_tolerance(c, co):
    """hi*hi alone (one TF32 pass) is tens of times off the f32 tolerance:
    the reason for the lo terms."""
    x, w, scale, bias, want, atol = _f32_case(c, co)
    got = _emulate_tf32x3_kernel(x, CV.pack_weight_tf32x3(w), co, scale, bias, relu=True, passes=1)
    assert float((got - want).abs().max()) > 10 * atol


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


# the tensor-core kernels at the edges of their tiling
_EDGE_CASES = [
    ((1, 32, 2, 7, 45), 32),  # ragged H and W (W % 8 and W % 4 != 0: scalar stores)
    ((2, 32, 1, 9, 72), 32),  # D = 1: both kd neighbours outside the volume
    ((1, 32, 3, 8, 64), 64),  # Co = 64, conv3d_fast's dgrad shape: two Co tiles
]


def _edge_case(dtype, shape, co, rtol, atol=None):
    """The kernel against the plain version with scale, bias and ReLU; one
    kernel launch, counted. atol defaults to the f32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).to(dtype).cuda()
    w = (torch.randn((co, shape[1], 3, 3, 3), generator=gen) * 0.1).to(dtype).cuda()
    sc = (torch.rand(co, generator=gen) + 0.5).cuda()
    bi = (torch.randn(co, generator=gen) * 0.1).cuda()
    before, before_bf16 = CV.LAUNCHES, CV.BF16_LAUNCHES
    got = CV.conv3d(x, w, sc, bi, relu=True)
    assert CV.LAUNCHES == before + 1
    assert CV.BF16_LAUNCHES == before_bf16 + (dtype == torch.bfloat16)
    want = CV.conv3d_reference(x, w, sc, bi, relu=True)
    if atol is None:
        atol = 1e-5 * max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,co",
    _EDGE_CASES + [
        ((1, 24, 3, 6, 40), 32),  # C not a multiple of 16
        ((1, 5, 2, 5, 9), 40),  # C < 16, Co not a multiple of 32
    ],
)
def test_cuda_bf16_kernel_edge_cases(shape, co):
    """The bf16 tensor-core kernel; bf16 tolerance: one ulp on top of the f32
    one, both round once."""
    _edge_case(torch.bfloat16, shape, co, 2.0**-7, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,co",
    _EDGE_CASES + [
        ((1, 12, 3, 6, 40), 32),  # C not a multiple of the 8-channel step
        ((1, 5, 2, 5, 9), 40),  # C < 8, Co not a multiple of 32
    ],
)
def test_cuda_f32_kernel_edge_cases(shape, co):
    """The f32 3xTF32 tensor-core kernel; the f32 tolerance, 1e-5 *
    max(1, max|ref|) (sums in another order)."""
    _edge_case(torch.float32, shape, co, 0.0)
