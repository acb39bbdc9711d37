"""The PyTorch port's ops and layers against the JAX package's (CPU).

On the CPU every kernel wrapper of ``multi_stylegan_torch`` runs its plain
PyTorch version; the JAX side runs its Pallas kernels in interpret mode, as
the JAX package's own tests do.  Inputs come from numpy and cross as arrays.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multi_stylegan_tpu.nn.equalized import EqualizedLinear as JaxEqualizedLinear
from multi_stylegan_tpu.nn.normalization import pixel_norm as jax_pixel_norm
from multi_stylegan_tpu.ops import modulated_conv as jax_modconv
from multi_stylegan_tpu.ops import pallas_kernels
from multi_stylegan_tpu.ops.blur import blur as jax_blur_fn
from multi_stylegan_tpu.ops.blur import blur_padding as jax_blur_padding
from multi_stylegan_tpu.ops.blur import make_blur_kernel as jax_make_blur_kernel
from multi_stylegan_tpu.ops.blur import upsample2x as jax_upsample2x
from multi_stylegan_tpu.ops.blur import upsample_padding as jax_upsample_padding
from multi_stylegan_tpu.ops.upfirdn2d import upfirdn2d_xla
from multi_stylegan_torch.nn.equalized import EqualizedLinear, FusedLeakyReLU
from multi_stylegan_torch.nn.normalization import pixel_norm
from multi_stylegan_torch.ops import blur, fused_act, modulated_conv
from multi_stylegan_torch.ops import upfirdn2d as port_upfirdn
from multi_stylegan_torch.ops.upfirdn2d import out_size, upfirdn2d

# (pad, k, h, w) of the Pallas stencil's own tests (test_pallas_upfirdn.py:20-35)
PALLAS_CASES = [
    ((2, 2), 4, 16, 16),
    ((2, 1), 4, 17, 16),
    ((1, 1), 3, 32, 16),
    ((2, 1), 4, 8, 8),
    ((3, 3), 4, 16, 8),
    ((3, 3), 4, 31, 16),
    ((3, 3), 4, 33, 16),
    ((0, 0), 4, 16, 16),
]


def _t(a):
    return torch.from_numpy(np.array(a))


# The Pallas stencil takes bf16 only where W % 16 == 0 (pallas_upfirdn_supported).
@pytest.mark.parametrize(
    "pad,k,h,w,c,dtype",
    [case + (c, dt)
     for case, c in [(case, 128) for case in PALLAS_CASES] + [(((2, 1), 4, 16, 16), 256)]
     for dt in ("float32", "bfloat16") if dt == "float32" or case[3] % 16 == 0],
)
def test_upfirdn2d_matches_pallas_kernel(rng, pad, k, h, w, c, dtype):
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    taps = rng.normal(size=(k, k)).astype(np.float32)
    norm = (pad[0], pad[1], pad[0], pad[1])
    xj = jnp.asarray(x).astype(dtype)
    assert pallas_kernels.pallas_upfirdn_supported(xj.shape, xj.dtype, k, k, 1, 1, norm)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_kernels.upfirdn2d_pallas(xj, jnp.asarray(taps), 1, norm)
    got = upfirdn2d(_t(x).to(getattr(torch, dtype)), _t(taps), pad=pad)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == ref.shape
    # f32: the same products summed in another order.  bf16: one rounding of
    # an f32 sum on each side, flips of one bf16 ulp allowed.
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "up,down,pad,k,c",
    [
        (2, 1, (2, 1), 4, 3),          # the OutputBlock skip upsample
        (1, 2, (1, 1), 4, 5),          # downsample
        (2, 2, (1, 2), 3, 4),
        (1, 1, (-1, 2), 4, 3),         # negative pad crops
        (2, 1, (1, 2, 0, 3), 4, 3),    # 4-tuple: (x0, x1, y0, y1)
        (1, 2, (2, 0, -1, 3), 3, 2),   # 4-tuple with a crop, downsampled
    ],
)
def test_upfirdn2d_matches_xla(rng, up, down, pad, k, c):
    x = rng.normal(size=(2, 9, 11, c)).astype(np.float32)
    taps = rng.normal(size=(k, k)).astype(np.float32)
    ref = np.asarray(upfirdn2d_xla(jnp.asarray(x), jnp.asarray(taps), up=up, down=down, pad=pad))
    got = upfirdn2d(_t(x), _t(taps), up=up, down=down, pad=pad).numpy()
    assert got.shape == ref.shape
    py0, py1, px0, px1 = port_upfirdn._normalize_pad(pad)
    assert got.shape[1:3] == (out_size(9, up, down, py0, py1, k), out_size(11, up, down, px0, px1, k))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version(rng):
    """A CPU tensor never reaches a kernel: no launch is counted."""
    x = _t(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    taps = blur.make_blur_kernel()
    before = (port_upfirdn.launches, fused_act.launches)
    got = upfirdn2d(x, taps, up=2, pad=(2, 1))
    torch.testing.assert_close(got, port_upfirdn.upfirdn2d_ref(x, taps, up=2, pad=(2, 1)))
    torch.testing.assert_close(fused_act.fused_leaky_relu(x, torch.ones(4)),
                               fused_act.fused_leaky_relu_ref(x, torch.ones(4)))
    assert (port_upfirdn.launches, fused_act.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 32), (2, 3, 3, 8), (2, 4, 4, 128)])
def test_fused_leaky_relu_matches_pallas_kernel(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=(shape[-1],)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_kernels.fused_leaky_relu_pallas(xj, jnp.asarray(b))
    got = fused_act.fused_leaky_relu(_t(x).to(getattr(torch, dtype)), _t(b))
    assert got.dtype == getattr(torch, dtype)
    # identical f32 arithmetic and one rounding to the storage type
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-6, atol=1e-6)


def test_fused_leaky_relu_module_on_nchw(rng):
    """The module takes NCHW (channels_last) and applies the bias per channel."""
    x = rng.normal(size=(2, 6, 5, 5)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    act = FusedLeakyReLU(6)
    with torch.no_grad():
        act.bias.copy_(_t(b))
        got = act(_t(x).contiguous(memory_format=torch.channels_last)).numpy()
    z = x + b[None, :, None, None]
    np.testing.assert_allclose(got, np.where(z >= 0, z, 0.2 * z), rtol=1e-6)


@pytest.mark.parametrize("n_taps,factor,k", [(4, 2, 3), (4, 2, 2), (4, 2, 1), (3, 2, 3), (6, 4, 2)])
def test_blur_paddings_match_jax(n_taps, factor, k):
    assert blur.blur_padding(n_taps, factor, k) == jax_blur_padding(n_taps, factor, k)
    assert blur.upsample_padding(n_taps, factor) == jax_upsample_padding(n_taps, factor)
    assert blur.blur_padding(4, 2, 2) == (2, 1) and blur.upsample_padding(4, 2) == (2, 1)


def test_blur_and_upsample_match_jax(rng):
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        blur.make_blur_kernel((1, 3, 3, 1), 4.0).numpy(),
        np.asarray(jax_make_blur_kernel((1, 3, 3, 1), 4.0)), rtol=1e-7)
    k4 = blur.make_blur_kernel(gain=4.0)
    np.testing.assert_allclose(
        blur.blur(_t(x), k4, (2, 1)).numpy(),
        np.asarray(jax_blur_fn(jnp.asarray(x), jax_make_blur_kernel(gain=4.0), (2, 1))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        blur.upsample2x(_t(x)).numpy(), np.asarray(jax_upsample2x(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,demodulate", [(3, True), (1, False), (3, False)])
def test_modulated_conv2d_matches_jax(rng, k, demodulate):
    b, cin, cout, h = 2, 6, 5, 7
    x = rng.normal(size=(b, h, h, cin)).astype(np.float32)
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)  # HWIO
    s = rng.normal(size=(b, cin)).astype(np.float32)
    scale = math.sqrt(2.0) / math.sqrt(cin * k * k)
    p = k // 2
    ref = jax_modconv.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), scale=scale,
        demodulate=demodulate, padding=((p, p), (p, p)))
    got = modulated_conv.modulated_conv2d(
        _t(x.transpose(0, 3, 1, 2)), _t(w.transpose(3, 2, 0, 1)), _t(s), scale=scale,
        demodulate=demodulate, padding=p)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv_transpose2d_matches_jax(rng, demodulate):
    b, cin, cout, h = 2, 6, 5, 4
    x = rng.normal(size=(b, h, h, cin)).astype(np.float32)
    w = rng.normal(size=(2, 2, cin, cout)).astype(np.float32)
    s = rng.normal(size=(b, cin)).astype(np.float32)
    scale = math.sqrt(2.0) / math.sqrt(cin * 4)
    ref = jax_modconv.modulated_conv_transpose2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), scale=scale, demodulate=demodulate)
    got = modulated_conv.modulated_conv_transpose2d(
        _t(x.transpose(0, 3, 1, 2)), _t(w.transpose(3, 2, 0, 1)), _t(s), scale=scale,
        demodulate=demodulate)
    assert got.shape == (b, cout, 2 * h, 2 * h)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_pixel_norm_matches_jax(rng):
    z = rng.normal(size=(4, 16)).astype(np.float32) * 3.0
    np.testing.assert_allclose(pixel_norm(_t(z)).numpy(),
                               np.asarray(jax_pixel_norm(jnp.asarray(z))), rtol=1e-6)


@pytest.mark.parametrize("use_bias,bias_init", [(False, 0.0), (True, 1.0)])
def test_equalized_linear_matches_jax(rng, use_bias, bias_init):
    x = rng.normal(size=(3, 12)).astype(np.float32)
    layer = JaxEqualizedLinear(7, use_bias=use_bias, bias_init=bias_init)
    params = layer.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32),
                          params)
    ref = layer.apply(params, jnp.asarray(x))
    port = EqualizedLinear(12, 7, bias=use_bias, bias_init=bias_init)
    with torch.no_grad():
        port.weight.copy_(_t(params["params"]["weight"].T))
        if use_bias:
            port.bias.copy_(_t(params["params"]["bias"]))
        got = port(_t(x))
    assert (port.bias is None) == (not use_bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ------------------------------------------------ gradients (K2, K4 wiring)
#
# The Functions' inner ops run their plain versions on the CPU, so these
# tests hold the autograd wiring itself (adjoint pads, tap flips, swapped
# up/down, the bias-sum transpose) against JAX's autodiff of the XLA ops:
# value, first gradient and grad-of-grad.  Tolerances: forward 1e-4 abs,
# gradients 1e-4 and grad-of-grad 1e-3 of the gradient's max abs (f32 on
# both sides, sums in other orders).


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _second_order(jax_fn, torch_fn, x, c, d):
    """L = sum(f(x)^2 * c); returns (f, dL/dx, d/dx sum(dL/dx * d)) from both."""
    def loss_j(xx):
        return jnp.sum(jnp.square(jax_fn(xx)) * c)

    ref_y = jax_fn(jnp.asarray(x))
    ref_g = jax.grad(loss_j)(jnp.asarray(x))
    ref_gg = jax.grad(lambda xx: jnp.sum(jax.grad(loss_j)(xx) * d))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = torch_fn(xt)
    (g,) = torch.autograd.grad((y.square() * _t(c)).sum(), xt, create_graph=True)
    (gg,) = torch.autograd.grad((g * _t(d)).sum(), xt)
    return (ref_y, ref_g, ref_gg), (y, g, gg)


UPFIRDN_GRAD_CASES = [
    (up, down, pad, k, h, w) for pad, k, h, w in PALLAS_CASES for up, down in [(1, 1)]
] + [
    (1, 1, (2, 2), 4, 15, 15),       # D downscale blur on an odd map
    (1, 1, (2, 2), 4, 15, 13),       # ... non-square
    (2, 1, (2, 1), 4, 5, 7),         # skip / decoder upsample (adjoint is down=2)
    (1, 2, (1, 1), 4, 9, 11),        # downsample (adjoint is up=2)
    (2, 2, (1, 2, 0, 3), 3, 9, 11),  # 4-tuple pad (x0, x1, y0, y1), non-square
    (1, 1, (-1, 2), 4, 9, 6),        # crop
]


@pytest.mark.parametrize("up,down,pad,k,h,w", UPFIRDN_GRAD_CASES)
def test_upfirdn2d_function_grad_and_grad_of_grad_match_jax(rng, up, down, pad, k, h, w):
    c_in = 3
    x = rng.normal(size=(2, h, w, c_in)).astype(np.float32)
    taps = rng.normal(size=(k, k)).astype(np.float32)
    y_shape = upfirdn2d(_t(x), _t(taps), up=up, down=down, pad=pad).shape
    cot = rng.normal(size=tuple(y_shape)).astype(np.float32)
    d = rng.normal(size=x.shape).astype(np.float32)
    (ry, rg, rgg), (y, g, gg) = _second_order(
        lambda xx: upfirdn2d_xla(xx, jnp.asarray(taps), up=up, down=down, pad=pad),
        lambda xx: upfirdn2d(xx, _t(taps), up=up, down=down, pad=pad), x, cot, d)
    _close(y, ry, 1e-4)
    _close(g, rg, 1e-4)
    _close(gg, rgg, 1e-3)


@pytest.mark.parametrize("scale", [1.0, math.sqrt(2.0)])
@pytest.mark.parametrize("shape", [(6, 5), (2, 5, 3, 4)])
def test_fused_leaky_relu_function_grad_and_grad_of_grad_match_jax(rng, shape, scale):
    """Includes the bias: its grad and the gg_db term of the double backward."""
    from multi_stylegan_tpu.ops.fused_act import fused_leaky_relu_xla

    x = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=(shape[-1],)).astype(np.float32)
    c = rng.normal(size=shape).astype(np.float32)
    dx_dir = rng.normal(size=shape).astype(np.float32)
    db_dir = rng.normal(size=(shape[-1],)).astype(np.float32)

    def loss_j(xx, bb):
        return jnp.sum(jnp.square(fused_leaky_relu_xla(xx, bb, 0.2, scale)) * c)

    def h_j(xx, bb):
        gx, gb = jax.grad(loss_j, argnums=(0, 1))(xx, bb)
        return jnp.sum(gx * dx_dir) + jnp.sum(gb * db_dir)

    xj, bj = jnp.asarray(x), jnp.asarray(b)
    ref_g = jax.grad(loss_j, argnums=(0, 1))(xj, bj)
    ref_gg = jax.grad(h_j, argnums=(0, 1))(xj, bj)
    xt, bt = _t(x).requires_grad_(True), _t(b).requires_grad_(True)
    y = fused_act.fused_leaky_relu(xt, bt, 0.2, scale)
    _close(y, fused_leaky_relu_xla(xj, bj, 0.2, scale), 1e-4)
    gx, gb = torch.autograd.grad((y.square() * _t(c)).sum(), (xt, bt), create_graph=True)
    _close(gx, ref_g[0], 1e-4)
    _close(gb, ref_g[1], 1e-4)
    ggx, ggb = torch.autograd.grad((gx * _t(dx_dir)).sum() + (gb * _t(db_dir)).sum(), (xt, bt))
    _close(ggx, ref_gg[0], 1e-3)
    _close(ggb, ref_gg[1], 1e-3)


def test_fused_leaky_relu_grad_matches_pallas_grad_kernel(rng):
    """The plain gradient (dx from the output's sign, f32 bias sum of the
    stored dx) is the Pallas grad kernel's, in f32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        g = rng.normal(size=(40, 24)).astype(np.float32)
        out = rng.normal(size=(40, 24)).astype(np.float32)
        gj, oj = jnp.asarray(g).astype(dtype), jnp.asarray(out).astype(dtype)
        with pltpu.force_tpu_interpret_mode():
            ref_dx = pallas_kernels._flr_grad_from_out(gj, oj, 0.2, 1.0)
        ref_db = np.asarray(ref_dx, np.float32).sum(0)
        dx, db = fused_act.fused_leaky_relu_grad_ref(
            _t(g).to(getattr(torch, dtype)), _t(out).to(getattr(torch, dtype)), 0.2, 1.0)
        np.testing.assert_array_equal(dx.float().numpy(), np.asarray(ref_dx, np.float32))
        np.testing.assert_allclose(db.numpy(), ref_db, rtol=1e-6, atol=1e-5)
