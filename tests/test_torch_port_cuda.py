"""The port's hand-written kernels on the GPU (marker ``cuda``).

The kernels have no CPU mode, so without a GPU every test here skips.  On a
machine with an NVIDIA GPU (JAX is not needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from multi_stylegan_torch.models.config import tiny_generator_config
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.ops import fused_act
from multi_stylegan_torch.ops import upfirdn2d as up_mod
from multi_stylegan_torch.ops.blur import make_blur_kernel

pytestmark = pytest.mark.cuda

# f32: the kernel and the plain version sum the same products in other
# orders.  bf16: each rounds one f32 value, so one bf16 ulp may differ.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA and Triton kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,up,down,pad,k",
    [
        ((2, 16, 16, 512), 1, 1, (2, 1), 4),     # post-upsample blur
        ((2, 8, 8, 3), 2, 1, (2, 1), 4),         # skip upsample
        ((2, 31, 16, 128), 1, 1, (3, 3), 4),     # ho > h
        ((2, 9, 11, 5), 1, 2, (1, 1), 4),        # downsample
        ((2, 9, 11, 5), 1, 1, (-1, 2), 4),       # crop
        ((2, 9, 11, 7), 2, 2, (1, 2, 0, 3), 3),  # 4-tuple pad (x0, x1, y0, y1)
    ],
)
def test_upfirdn2d_kernel_matches_plain(cuda, shape, up, down, pad, k, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    taps = torch.randn((k, k), generator=g, device=cuda)
    before = up_mod.launches
    got = up_mod.upfirdn2d(x, taps, up=up, down=down, pad=pad)
    assert up_mod.launches == before + 1
    ref = up_mod.upfirdn2d_ref(x, taps, up=up, down=down, pad=pad)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 512), (2, 8, 8, 512), (1000, 130)])
def test_fused_leaky_relu_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    bias = torch.randn(shape[-1], generator=g, device=cuda)
    before = fused_act.launches
    got = fused_act.fused_leaky_relu(x, bias)
    assert fused_act.launches == before + 1
    ref = fused_act.fused_leaky_relu_ref(x, bias)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(24, 512), (2, 8, 8, 512), (1000, 130), (6, 15, 15, 768)])
def test_fused_leaky_relu_grad_kernel_matches_plain_autograd(cuda, shape, dtype):
    """K2: dx and the bias grad against autograd of the plain version, and
    the double backward (the gg_db term included) against its autograd."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype).requires_grad_(True)
    bias = torch.randn(shape[-1], generator=g, device=cuda).requires_grad_(True)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype).requires_grad_(True)
    before = fused_act.grad_launches
    y = fused_act.fused_leaky_relu(x, bias, 0.2, 2.0 ** 0.5)
    dx, db = torch.autograd.grad(y, (x, bias), gy, create_graph=True)
    assert fused_act.grad_launches == before + 1
    xr, br = x.detach().clone().requires_grad_(True), bias.detach().clone().requires_grad_(True)
    gr = gy.detach().clone().requires_grad_(True)
    yr = fused_act.fused_leaky_relu_ref(xr, br, 0.2, 2.0 ** 0.5)
    rdx, rdb = torch.autograd.grad(yr, (xr, br), gr, create_graph=True)
    torch.testing.assert_close(dx, rdx, **TOL[dtype])
    # the bias grad sums the STORED dx (as the JAX package does), autograd of
    # the plain version sums it unrounded: in bf16 they agree to 2^-7 of the
    # peak, not per element; against the plain grad function they agree up
    # to the f32 summation order
    peak = float(rdb.detach().abs().max())
    tol_db = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(db, rdb, rtol=0, atol=tol_db * max(1.0, peak))
    _, pdb = fused_act.fused_leaky_relu_grad_ref(gy.detach(), y.detach(), 0.2, 2.0 ** 0.5)
    torch.testing.assert_close(db, pdb, rtol=1e-5, atol=1e-5 * max(1.0, peak))
    # double backward in the cotangent, the bias-sum term (gg_db) included
    c1 = torch.randn(shape, generator=g, device=cuda).to(dtype)
    c2 = torch.randn(shape[-1], generator=g, device=cuda)
    (ggy,) = torch.autograd.grad((dx.float() * c1).sum() + (db * c2).sum(), gy)
    (rggy,) = torch.autograd.grad((rdx.float() * c1).sum() + (rdb * c2).sum(), gr)
    assert fused_act.grad_launches == before + 2
    torch.testing.assert_close(ggy, rggy, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,up,down,pad",
    [
        ((2, 16, 16, 512), 1, 1, (2, 1)),      # G post-upsample blur
        ((2, 8, 8, 3), 2, 1, (2, 1)),          # G skip upsample: adjoint is down=2
        ((2, 15, 15, 768), 1, 1, (2, 2)),      # D downscale blur on an odd map
        ((2, 16, 16, 1024), 2, 1, (2, 1)),     # D decoder upsample
        ((2, 9, 11, 7), 2, 2, (1, 2, 0, 3)),   # non-square, 4-tuple pad
    ],
)
def test_upfirdn2d_grad_kernels_match_plain_autograd(cuda, shape, up, down, pad, dtype):
    """K4: the backward and the double backward against autograd of the
    plain version; each gradient launch is counted as K4."""
    g = torch.Generator(device=cuda).manual_seed(3)
    taps = make_blur_kernel(device=cuda)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype).requires_grad_(True)
    y = up_mod.upfirdn2d(x, taps, up=up, down=down, pad=pad)
    gy = torch.randn(y.shape, generator=g, device=cuda).to(dtype).requires_grad_(True)
    before = up_mod.grad_launches
    (gx,) = torch.autograd.grad(y, x, gy, create_graph=True)
    assert up_mod.grad_launches == before + 1
    gg = torch.randn(shape, generator=g, device=cuda).to(dtype)
    (ggy,) = torch.autograd.grad(gx, gy, gg)
    assert up_mod.grad_launches == before + 2
    xr = x.detach().clone().requires_grad_(True)
    gr = gy.detach().clone().requires_grad_(True)
    (rgx,) = torch.autograd.grad(up_mod.upfirdn2d_ref(xr, taps, up, down, pad), xr, gr,
                                 create_graph=True)
    (rggy,) = torch.autograd.grad(rgx, gr, gg)
    torch.testing.assert_close(gx, rgx, **TOL[dtype])
    torch.testing.assert_close(ggy, rggy, **TOL[dtype])


def test_cuda_calls_with_gradients_go_through_the_kernels(cuda):
    """Where slice 1 raised, a CUDA call that needs a gradient now launches
    the kernels forward and backward."""
    x = torch.randn(1, 8, 8, 16, device=cuda, requires_grad=True)
    bias = torch.zeros(16, device=cuda, requires_grad=True)
    counts = (fused_act.launches, fused_act.grad_launches, up_mod.launches, up_mod.grad_launches)
    y = fused_act.fused_leaky_relu(up_mod.upfirdn2d(x, make_blur_kernel(device=cuda), pad=(2, 1)),
                                   bias)
    y.square().sum().backward()
    after = (fused_act.launches, fused_act.grad_launches, up_mod.launches, up_mod.grad_launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 1, 1, 1)
    assert x.grad.shape == x.shape and bias.grad.shape == (16,)


def test_kernels_refuse_what_they_do_not_take(cuda):
    nchw = torch.randn(1, 16, 8, 8, device=cuda)
    taps = make_blur_kernel(device=cuda)
    with pytest.raises(ValueError, match="NHWC"):
        up_mod.upfirdn2d(nchw.permute(0, 2, 3, 1), taps, pad=(2, 1))
    with pytest.raises(ValueError, match="taps"):
        up_mod.upfirdn2d(nchw.contiguous(), taps.double(), pad=(2, 1))
    with pytest.raises(ValueError, match="channel axis"):
        fused_act.fused_leaky_relu(nchw.permute(0, 2, 3, 1), torch.zeros(16, device=cuda))
    with pytest.raises(TypeError):
        fused_act.fused_leaky_relu(nchw.double(), None)


def test_tiny_generator_on_the_card_matches_the_cpu(cuda):
    cfg = tiny_generator_config()
    cpu = Generator(cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    gpu = Generator(cfg).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    z = torch.randn(2, cfg.latent_dimensions, generator=torch.Generator().manual_seed(1))
    counts = (fused_act.launches, up_mod.launches)
    with torch.inference_mode():
        ref = cpu(z, randomize_noise=False)
        got = gpu(z.to(cuda), randomize_noise=False).cpu()
    # mapping (2) + one act per StyledConv (7 per tower); blur + skip upsample
    # per stage and tower
    assert (fused_act.launches - counts[0], up_mod.launches - counts[1]) == (16, 12)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
