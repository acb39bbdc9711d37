"""The port's hand-written kernels on the GPU (marker ``cuda``).

The kernels have no CPU mode, so without a GPU every test here skips.  On a
machine with an NVIDIA GPU (JAX is not needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import math

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


# (shape, storage offset in elements): the vector form at C = 512 / 1024,
# the scalar form at C = 130 and on a view 2 elements off 16-byte alignment
K2_FORMS = [((24, 512), 0), ((6, 15, 15, 768), 0), ((1000, 130), 0),
            ((4, 33, 7, 1024), 0), ((3, 9, 9, 256), 2)]


def _k2_inputs(cuda, shape, offset, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = math.prod(shape)
    grad = torch.randn(n + offset, generator=g, device=cuda).to(dtype)[offset:].view(shape)
    out = torch.randn(n + offset, generator=g, device=cuda).to(dtype)[offset:].view(shape)
    addend = torch.randn(shape[-1], generator=g, device=cuda)
    return grad, out, addend


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", K2_FORMS)
def test_fused_leaky_relu_grad_dx_only_and_addend_forms(cuda, shape, offset, dtype):
    """K2's dx-only form with an f32 addend is bitwise the plain version
    (which rounds the addend and the sum to g's dtype, as gg_dx +
    gg_db.to(dtype) does); the full form with an addend gives the plain
    version's dx bitwise and its bias sum up to the f32 summation order."""
    grad, out, addend = _k2_inputs(cuda, shape, offset, dtype, 3)
    counts = (fused_act.grad_launches, fused_act.grad_dx_only_launches)
    dx, db = fused_act._grad(grad, out, 0.2, 2.0 ** 0.5, addend, need_db=False)
    assert db is None
    assert (fused_act.grad_launches, fused_act.grad_dx_only_launches) == (counts[0] + 1,
                                                                         counts[1] + 1)
    rdx, _ = fused_act.fused_leaky_relu_grad_ref(grad, out, 0.2, 2.0 ** 0.5, addend,
                                                 need_db=False)
    torch.testing.assert_close(dx, rdx, rtol=0, atol=0)
    assert torch.equal(dx, fused_act.fused_leaky_relu_grad_ref(
        grad + addend.to(dtype), out, 0.2, 2.0 ** 0.5)[0])
    dx, db = fused_act._grad(grad, out, 0.2, 2.0 ** 0.5, addend)
    rdx, rdb = fused_act.fused_leaky_relu_grad_ref(grad, out, 0.2, 2.0 ** 0.5, addend)
    torch.testing.assert_close(dx, rdx, rtol=0, atol=0)
    torch.testing.assert_close(db, rdb, rtol=1e-5, atol=1e-5 * max(1.0, float(rdb.abs().max())))
    dx, _ = fused_act._grad(grad, out, 0.2, 2.0 ** 0.5, need_db=False)
    torch.testing.assert_close(dx, fused_act.fused_leaky_relu_grad_ref(
        grad, out, 0.2, 2.0 ** 0.5)[0], rtol=0, atol=0)


def test_fused_leaky_relu_grad_refuses_what_it_does_not_take(cuda):
    """K2 raises rather than copies: a non-contiguous cotangent, an output of
    another dtype, an addend that is not a contiguous f32 [C]."""
    grad, out, addend = _k2_inputs(cuda, (2, 8, 8, 64), 0, torch.float32, 5)
    with pytest.raises(ValueError, match="channel axis"):
        fused_act._grad(grad.transpose(1, 2), out, 0.2, 1.0)
    with pytest.raises(ValueError, match="out must be"):
        fused_act._grad(grad, out.bfloat16(), 0.2, 1.0)
    with pytest.raises(ValueError, match="addend"):
        fused_act._grad(grad, out, 0.2, 1.0, addend[:32], need_db=False)
    with pytest.raises(ValueError, match="addend"):
        fused_act._grad(grad, out, 0.2, 1.0, addend.bfloat16(), need_db=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(24, 64, 64, 512), (24, 256, 256, 128), (1000, 130)])
def test_fused_leaky_relu_grad_bias_sum_is_the_same_bits_every_launch(cuda, shape, dtype):
    """The bias sum runs over several row blocks and the last one adds their
    partial rows in a fixed order: two launches give the same bits."""
    grad, out, _ = _k2_inputs(cuda, shape, 0, dtype, 4)
    assert fused_act._grad_plan(math.prod(shape[:-1]), shape[-1], dtype, True,
                                fused_act._sm_count(grad.device), True).partial_rows > 1
    _, db1 = fused_act._grad(grad, out, 0.2, 1.0)
    _, db2 = fused_act._grad(grad, out, 0.2, 1.0)
    assert torch.equal(db1, db2)
    _, rdb = fused_act.fused_leaky_relu_grad_ref(grad, out, 0.2, 1.0)
    torch.testing.assert_close(db1, rdb, rtol=1e-5, atol=1e-5 * max(1.0, float(rdb.abs().max())))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,up,down,pad,variants",
    [
        ((1, 127, 127, 128), 1, 1, (2, 2), ("up1-down1", "up1-down1")),  # D blurs, odd maps
        ((2, 63, 63, 256), 1, 1, (2, 2), ("up1-down1", "up1-down1")),
        ((2, 15, 15, 768), 1, 1, (2, 2), ("up1-down1", "up1-down1")),
        ((2, 20, 37, 64), 1, 1, (2, 1), ("up1-down1", "up1-down1")),     # H != W
        ((2, 33, 17, 512), 1, 1, (1, 2), ("up1-down1", "up1-down1")),    # G blur adjoint pads
        ((2, 17, 33, 8), 1, 1, (0, 3, 1, 2), ("up1-down1", "up1-down1")),  # asymmetric, C = 8
        ((2, 9, 23, 24), 1, 1, (3, 0, -1, 2), ("up1-down1", "up1-down1")),  # crop, C = 24
        ((3, 21, 45, 24), 2, 1, (2, 1), ("up2-down1", "up1-down2")),     # ragged width
        ((2, 9, 13, 24), 2, 1, (2, 1, 1, 2), ("up2-down1", "up1-down2")),  # odd y0, even x0
        ((2, 9, 11, 32), 2, 1, (3, 0), ("up2-down1", "up1-down2")),      # odd pads
        ((4, 32, 32, 256), 2, 1, (2, 1), ("up2-down1", "up1-down2")),    # D decoder upsample
        ((4, 64, 64, 256), 1, 2, (1, 1), ("up1-down2", "up2-down1")),    # up=2 adjoint
        ((2, 33, 19, 8), 1, 2, (2, 1, 0, 2), ("up1-down2", "up2-down1")),
        ((2, 16, 16, 130), 1, 1, (2, 1), ("general", "general")),        # C not a vector multiple
    ],
)
def test_upfirdn2d_variants_match_plain(cuda, shape, up, down, pad, variants, dtype):
    """Each tiled variant at its edges, forward and adjoint, against the
    plain version and its autograd; the variant each launch took."""
    g = torch.Generator(device=cuda).manual_seed(4)
    taps = torch.randn((4, 4), generator=g, device=cuda)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    y = up_mod.upfirdn2d(x, taps, up=up, down=down, pad=pad)
    taken = [up_mod.last_variant]
    gy = torch.randn(y.shape, generator=g, device=cuda).to(dtype)
    gx = up_mod.UpFirDn2dBackward.apply(gy, taps, up, down, up_mod._normalize_pad(pad),
                                        shape[1:3], tuple(y.shape[1:3]))
    taken.append(up_mod.last_variant)
    xr = x.clone().requires_grad_(True)
    (rgx,) = torch.autograd.grad(up_mod.upfirdn2d_ref(xr, taps, up, down, pad), xr, gy)
    assert tuple(taken) == variants
    torch.testing.assert_close(y.float(), up_mod.upfirdn2d_ref(x, taps, up, down, pad).float(),
                               **TOL[dtype])
    torch.testing.assert_close(gx, rgx, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upfirdn2d_misaligned_view_takes_the_general_variant(cuda, dtype):
    """A contiguous view one element into its storage is not 16-byte
    aligned: forward and adjoint take the general variant and stay right."""
    g = torch.Generator(device=cuda).manual_seed(5)
    taps = make_blur_kernel(device=cuda)
    flat = torch.randn(2 * 16 * 16 * 256 + 1, generator=g, device=cuda).to(dtype)
    x = flat[1:].view(2, 16, 16, 256)
    assert x.data_ptr() % 16
    y = up_mod.upfirdn2d(x, taps, up=2, pad=(2, 1))
    assert up_mod.last_variant == "general"
    gflat = torch.randn(y.numel() + 1, generator=g, device=cuda).to(dtype)
    gy = gflat[1:].view(y.shape)
    gx = up_mod.UpFirDn2dBackward.apply(gy, taps, 2, 1, (2, 1, 2, 1), (16, 16), (32, 32))
    assert up_mod.last_variant == "general"
    xr = x.clone().requires_grad_(True)
    (rgx,) = torch.autograd.grad(up_mod.upfirdn2d_ref(xr, taps, 2, 1, (2, 1)), xr, gy)
    torch.testing.assert_close(y, up_mod.upfirdn2d_ref(x, taps, 2, 1, (2, 1)), **TOL[dtype])
    torch.testing.assert_close(gx, rgx, **TOL[dtype])


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


def _counts():
    return (fused_act.launches, fused_act.grad_launches, fused_act.grad_dx_only_launches,
            up_mod.launches, up_mod.grad_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_rows_launch_nothing(cuda, dtype):
    """A data rank's empty share of a batch: K1, K2 (bias sum and dx-only),
    K3 at each tiled up/down form and K4 return empty results of the right
    shape and dtype (K2 a zero bias sum) and launch no kernel; an input
    empty for any other reason still raises."""
    taps = make_blur_kernel(device=cuda)
    before = _counts()
    x = torch.randn(0, 8, 8, 16, device=cuda, dtype=dtype, requires_grad=True)
    bias = torch.randn(16, device=cuda, requires_grad=True)
    y = fused_act.fused_leaky_relu(x, bias)
    v = torch.randn(y.shape, device=cuda, dtype=dtype, requires_grad=True)
    gx, gb = torch.autograd.grad((y * v).sum(), [x, bias], create_graph=True)
    (gv,) = torch.autograd.grad(gx.float().square().sum() + gb.square().sum(), v)
    assert y.shape == gx.shape == gv.shape == x.shape and y.dtype == gx.dtype == dtype
    assert torch.equal(gb, torch.zeros(16, device=cuda))
    for up, down, pad in ((1, 1, (2, 1)), (2, 1, (2, 1)), (1, 2, (1, 1))):
        y = up_mod.upfirdn2d(x, taps, up, down, pad)
        ho = up_mod.out_size(8, up, down, pad[0], pad[1], 4)
        assert y.shape == (0, ho, ho, 16) and y.dtype == dtype
        v = torch.randn(y.shape, device=cuda, dtype=dtype, requires_grad=True)
        (gx,) = torch.autograd.grad((y * v).sum(), x, create_graph=True)
        (gv,) = torch.autograd.grad(gx.float().square().sum(), v)
        assert gx.shape == x.shape and gv.shape == y.shape
    assert _counts() == before
    with pytest.raises(ValueError, match="empty"):
        fused_act.fused_leaky_relu(torch.randn(2, 8, 8, 0, device=cuda, dtype=dtype), None)
    with pytest.raises(ValueError, match="empty"):
        up_mod.upfirdn2d(torch.randn(2, 0, 8, 16, device=cuda, dtype=dtype), taps, pad=(2, 1))
