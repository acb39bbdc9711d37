"""The port's hand-written kernels on the GPU (marker ``cuda``).

The kernels have no CPU mode, so without a GPU every test here skips.  On a
machine with an NVIDIA GPU (JAX is not needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import math

import pytest
import torch

from multi_stylegan_torch.models.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.ops import fused_act, fused_optim
from multi_stylegan_torch.ops import upfirdn2d as up_mod
from multi_stylegan_torch.ops.blur import make_blur_kernel
from multi_stylegan_torch.train.state import ClippedAdam

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


# ------------------------------------------------- the fused optimizer updates


def _leaf_groups(cuda, model, size):
    """A model's leaves in its optimizer's groups, as the trainer makes them
    (G: the style mapping at lr x 0.01), each N(0, 1) from a seed."""
    if model == "G":
        gen = Generator(tiny_generator_config() if size == "tiny" else GeneratorConfig(),
                        device=cuda)
        style = {id(p) for p in gen.style_mapping.parameters()}
        groups = [([p for p in gen.parameters() if id(p) not in style], 2e-4),
                  (list(gen.style_mapping.parameters()), 2e-6)]
    else:
        disc = Discriminator(tiny_discriminator_config() if size == "tiny"
                             else DiscriminatorConfig(), device=cuda)
        groups = [(list(disc.parameters()), 6e-4)]
    seeded = torch.Generator(device=cuda).manual_seed(7)
    with torch.no_grad():
        for ps, _ in groups:
            for p in ps:
                p.copy_(torch.randn(p.shape, generator=seeded, device=cuda))
    return groups


def _twins(groups, n=2, **kw):
    """``n`` optimizers over copies of the same leaves."""
    return [ClippedAdam([([torch.nn.Parameter(p.detach().clone()) for p in ps], lr)
                         for ps, lr in groups], **kw) for _ in range(n)]


def _tensors(opt):
    """``opt``'s tensors and scalars, as ops/fused_optim.py's steps take them."""
    return dict(params=opt.params, exp_avg=opt.exp_avg, exp_avg_sq=opt.exp_avg_sq,
                count=opt.count, notfinite_count=opt.notfinite_count,
                lrs=[lr for ps, lr in opt.groups for _ in ps],
                sharded=[d is not None for d in opt.shard_dims], hyper=opt.hyper())


def _plain_step(opt, grads, model_sum=None):
    return fused_optim.clipped_adam_ref(grads=grads, model_sum=model_sum, **_tensors(opt))


def _other_layout(i, g):
    """Leaf ``i``'s gradient ``g`` in another memory order, as cuDNN gives a
    conv weight's: channels-last or input channels outermost (4-d, in
    turn), column-major (2-d); 5-d with its dims 1 and 2 swapped, which the
    kernels do not read (copied)."""
    if g.dim() == 4 and i % 2:
        return g.contiguous(memory_format=torch.channels_last)
    if g.dim() in (2, 4):
        return g.transpose(0, 1).contiguous().transpose(0, 1)
    if g.dim() == 5:
        return g.transpose(1, 2).contiguous().transpose(1, 2)
    return g


def _step_grads(opt, seed, norm, nones=(), nan_leaf=None, layouts=False):
    """Gradients of global norm ``norm``; None at the leaves ``nones``, a
    NaN in leaf ``nan_leaf``; with ``layouts``, in other memory orders
    (:func:`_other_layout`)."""
    gen = torch.Generator(device=opt.params[0].device).manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen, device=p.device) for p in opt.params]
    total = torch.sqrt(sum(g.square().sum() for g in grads))
    grads = [g * (norm / total) for g in grads]
    if nan_leaf is not None:
        grads[nan_leaf].view(-1)[grads[nan_leaf].numel() // 2] = float("nan")
    if layouts:
        grads = [_other_layout(i, g) for i, g in enumerate(grads)]
    return [None if i in nones else g for i, g in enumerate(grads)]


def _state_of(opt):
    return [t.detach().clone() for t in opt.params + opt.exp_avg + opt.exp_avg_sq] + [
        opt.count.clone(), opt.notfinite_count.clone()]


def _assert_matches(fused, plain, exact=False, equal_nan=False):
    """Parameters and moments: the same bits where the step did not clip
    (every operation is the plain loop's), else within rtol 1e-6 of each
    value and of the model's peak of its kind: the clip scales by max_norm
    / g_norm, and g_norm sums the squares in another order (a last-bit
    difference, which a value near zero, where p + update or (1 - b1) g +
    b1 m cancel, carries as a large relative one)."""
    for kind in ("params", "exp_avg", "exp_avg_sq"):
        got = [t.detach() for t in getattr(fused, kind)]
        want = [t.detach() for t in getattr(plain, kind)]
        peak = max(float(torch.nan_to_num(t, nan=0.0).abs().max()) for t in want)
        for a, b in zip(got, want):
            if exact:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * peak,
                                           equal_nan=equal_nan)
    assert int(fused.count) == int(plain.count)
    assert int(fused.notfinite_count) == int(plain.notfinite_count)


@pytest.mark.parametrize("b1", [0.0, 0.9])
@pytest.mark.parametrize("size", ["tiny", "paper"])
@pytest.mark.parametrize("model", ["G", "D"])
def test_fused_adam_matches_the_plain_loop(cuda, model, size, b1):
    """The fused step against the plain loop on the card, step after step:
    the clip firing (with None gradients), not firing, a non-finite
    gradient skipped twice (parameters, moments and count the same bits,
    the skip counter up by one each time), then applied anyway past
    ``max_consecutive_nonfinite``; G's two lr groups; at most 4 launches a
    step."""
    fused, plain = _twins(_leaf_groups(cuda, model, size), b1=b1, max_consecutive_nonfinite=2)
    n = len(fused.params)
    steps = [dict(seed=1, norm=0.5, nones=set(range(0, n, 5))),   # no clip
             dict(seed=2, norm=50.0, nones=set(range(2, n, 7))),  # the clip fires
             dict(seed=3, norm=0.5, layouts=True),                 # other layouts
             dict(seed=4, norm=50.0, nones={n - 1}, layouts=True)]
    for k, kw in enumerate(steps):
        before = fused_optim.adam_launches
        grads = _step_grads(fused, **kw)
        assert any(g is not None and not g.is_contiguous()
                   for g in grads) == kw.get("layouts", False)
        copied = sum(g is not None and not g.is_contiguous() and g.dim() == 5 for g in grads)
        applied = fused.step(grads)
        launches = fused_optim.adam_launches - before
        # two launches, and a copy of each gradient in a layout they do not read
        assert launches - copied == 2
        assert bool(_plain_step(plain, _step_grads(plain, **kw)))
        assert bool(applied)
        _assert_matches(fused, plain, exact=k == 0)
    nan_leaf = n // 2
    for k in (1, 2):  # skipped: nothing moves but the skip counter
        was = _state_of(fused)
        applied = fused.step(_step_grads(fused, 10 + k, 1.0, nan_leaf=nan_leaf))
        assert not bool(applied)
        now = _state_of(fused)
        assert all(torch.equal(a, b) for a, b in zip(was[:-1], now[:-1]))
        assert int(now[-1]) == int(was[-1]) + 1 == k
        _plain_step(plain, _step_grads(plain, 10 + k, 1.0, nan_leaf=nan_leaf))
        _assert_matches(fused, plain)
    applied = fused.step(_step_grads(fused, 13, 1.0, nan_leaf=nan_leaf))  # forced
    assert bool(applied) and int(fused.notfinite_count) == 3 and int(fused.count) == 5
    _plain_step(plain, _step_grads(plain, 13, 1.0, nan_leaf=nan_leaf))
    _assert_matches(fused, plain, equal_nan=True)
    assert bool(fused.params[nan_leaf].isnan().any())


@pytest.mark.parametrize("model", ["G", "D"])
def test_fused_adam_is_the_same_bits_every_run(cuda, model):
    a, b = _twins(_leaf_groups(cuda, model, "paper"))
    for seed, norm in ((1, 50.0), (2, 0.5), (3, 50.0)):
        a.step(_step_grads(a, seed, norm))
        b.step(_step_grads(b, seed, norm))
    assert all(torch.equal(x, y) for x, y in zip(_state_of(a), _state_of(b)))


def test_fused_adam_keeps_the_sharded_sum_apart(cuda):
    """Tensor-parallel leaves: the sharded sum and the non-finite flag go
    through ``model_sum`` (here a stand-in for two ranks holding the same
    block), the replicated sum does not, as in the plain loop."""
    groups = _leaf_groups(cuda, "G", "tiny")
    n = sum(len(ps) for ps, _ in groups)
    dims = [0 if i % 3 == 0 else None for i in range(n)]
    fused, plain = _twins(groups, shard_dims=dims)
    calls = []

    def two_ranks(x):
        calls.append(x.clone())
        return x * 2

    for seed, norm in ((1, 2.0), (2, 20.0)):  # with the doubled sum: no clip, then a clip
        _, fused.tables = fused_optim.clipped_adam(
            grads=_step_grads(fused, seed, norm), model_sum=two_ranks, tables=fused.tables,
            **_tensors(fused))
        _plain_step(plain, _step_grads(plain, seed, norm), two_ranks)
        _assert_matches(fused, plain, exact=norm < 3)
    torch.testing.assert_close(calls[0], calls[1], rtol=1e-6, atol=0)  # fused, plain


def test_fused_adam_follows_a_changed_learning_rate(cuda):
    """The kernels' tables hold each leaf's learning rate: a group's new
    rate after a step is the one the next step takes."""
    fused, plain = _twins(_leaf_groups(cuda, "G", "tiny"))
    for k, (seed, norm) in enumerate(((1, 0.5), (2, 0.5))):
        if k:
            for opt in (fused, plain):
                opt.groups[1] = (opt.groups[1][0], 3e-3)
        fused.step(_step_grads(fused, seed, norm))
        _plain_step(plain, _step_grads(plain, seed, norm))
        _assert_matches(fused, plain, exact=True)
    assert fused.tables.key[3][-1] == 3e-3


def test_fused_adam_takes_unaligned_gradients(cuda):
    """Gradients that are views into one bucket at 4-byte offsets (a
    data-parallel all-reduce's) take the scalar form."""
    fused, plain = _twins(_leaf_groups(cuda, "D", "tiny"))
    for seed, norm in ((1, 0.5), (2, 20.0)):
        grads = _step_grads(fused, seed, norm)
        flat = torch.cat([torch.zeros(1, device=cuda)] + [g.reshape(-1) for g in grads])
        views, at = [], 1
        for g in grads:
            views.append(flat[at:at + g.numel()].view(g.shape))
            at += g.numel()
        assert views[0].data_ptr() % 16 != 0
        fused.step(views)
        _plain_step(plain, grads)
        _assert_matches(fused, plain, exact=norm < 5)


def test_fused_adam_refuses_what_it_does_not_take(cuda):
    (opt,) = _twins(_leaf_groups(cuda, "D", "tiny"), n=1)
    grads = _step_grads(opt, 1, 1.0)
    with pytest.raises(ValueError, match="must be an f32"):
        opt.step([grads[0].to(torch.bfloat16)] + grads[1:])
    with pytest.raises(ValueError, match="must be an f32"):
        opt.step([grads[0].reshape(-1)] + grads[1:])
    with pytest.raises(ValueError, match="gradients for"):
        opt.step(grads[:-1])


@pytest.mark.parametrize("size", ["tiny", "paper"])
def test_fused_ema_matches_the_plain_loop(cuda, size):
    torch.manual_seed(3)
    cfg = tiny_generator_config() if size == "tiny" else GeneratorConfig()
    model = Generator(cfg, device=cuda)
    ema = [p.detach().clone() + 0.01 for p in model.parameters()]
    plain = [e.clone() for e in ema]
    for _ in range(2):
        before = fused_optim.ema_launches
        fused_optim.ema_update(ema, list(model.parameters()), 0.999)
        assert fused_optim.ema_launches - before == 1
        fused_optim.ema_update_ref(plain, list(model.parameters()), 0.999)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.1)
    for a, b in zip(ema, plain):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-30)
