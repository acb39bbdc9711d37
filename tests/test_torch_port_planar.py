"""The planar layout of the generator's f32 forward with autograd off.

Such a forward keeps its activations NCHW-contiguous, and K1 (fused
leaky-ReLU) and K3 (upfirdn2d) take them as the ``permute(0, 2, 3, 1)`` view
of an NCHW-contiguous tensor; every other forward keeps ``channels_last``.
The CPU tests hold the layout choice (the generator's, FusedLeakyReLU's and
the tensor-parallel gather's), the plain versions on planar views, K1's planar
grid, the benchmark's census of planar launches and the kernels' names; the
sampling sites come from chip_smoke.py's census; the tests
marked ``cuda`` hold the planar kernels on the card and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_port_planar.py
"""

import collections
import importlib.util
import multiprocessing
import os
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_bench import kernels
from gpu_bench.bench import load_json, port_configs
from multi_stylegan_torch.models import generator as gen_mod
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.ops import fused_act
from multi_stylegan_torch.ops import upfirdn2d as up_mod
from multi_stylegan_torch.ops.blur import make_blur_kernel
from multi_stylegan_torch.nn.equalized import FusedLeakyReLU
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.parallel import tensor as tp

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py, whose census of the sampling sites and planar views
    its phase 2 runs on the card and these tests share."""
    spec = importlib.util.spec_from_file_location("chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _chip_smoke()
planar, sampling_sites, site_taps = _SMOKE.planar, _SMOKE.sampling_sites, _SMOKE.site_taps
CONFIGS = {"msg256": "msg256-f32", "sg2f1024": "sg2f-ffhq1024-f32"}
# Planar against channels_last, as a share of the image's peak.  The kernels
# give the same bits in both layouts; the convolutions do not: each layout
# runs its own convolution algorithm, which sums in its own order (1.1e-6 to
# 1.6e-6 of the peak over three seeds of the tiny config on the CPU).
IMAGE_TOL = 5e-6
# K3's planar forms against the plain version, as a share of the peak.
K3_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config_f_shaped(**kw):
    """The tiny config with config F's shape: one tower, k3 up-convs, the
    skip upsample's gain 4 and a toRGB bias per channel."""
    return tiny_generator_config(num_domains=1, up_kernel_size=3, skip_upsample_gain=4.0,
                                 rgb_bias_per_channel=True, **kw)


def bench_config(name):
    """The generator config of a sampling cell of the benchmark."""
    return port_configs(load_json(ROOT / "gpu_bench" / "configs" / f"{CONFIGS[name]}.json"))[0]


def generator(cfg, device="cpu", seed=0):
    g = Generator(cfg)
    g.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # every leaf nonzero, so biases and noise weights carry signal
        rng = torch.Generator().manual_seed(seed + 1)
        for p in g.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=rng))
    return g.to(device)


def forward(g, z, layout=None):
    """The f32 forward without autograd, in the layout it chooses or in
    ``layout``."""
    choose = gen_mod.layout
    if layout is not None:
        gen_mod.layout = lambda dtype: layout
    try:
        with torch.no_grad():
            return g(z, randomize_noise=False)
    finally:
        gen_mod.layout = choose


def peak_gap(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


class Dispatch:
    """Records the layout of every 4-D tensor sent to K1's and K3's
    dispatchers, which then run as they would."""

    def __init__(self, monkeypatch):
        self.seen = collections.Counter()
        f1, f3 = fused_act._forward, up_mod._upfirdn

        def k1(x, *a, **kw):
            if x.dim() == 4:
                self.seen[("K1", fused_act.is_planar(x))] += 1
            return f1(x, *a, **kw)

        def k3(x, *a, **kw):
            self.seen[("K3", fused_act.is_planar(x))] += 1
            return f3(x, *a, **kw)

        monkeypatch.setattr(fused_act, "_forward", k1)
        monkeypatch.setattr(up_mod, "_upfirdn", k3)


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("dtype,grad,want", [
    (torch.float32, False, "planar"), (torch.float32, True, "channels_last"),
    (torch.bfloat16, False, "channels_last"), (torch.bfloat16, True, "channels_last")])
def test_layout_is_planar_for_f32_without_autograd(dtype, grad, want):
    with torch.set_grad_enabled(grad):
        assert gen_mod.layout(dtype) == want
    with torch.inference_mode():
        assert gen_mod.layout(torch.float32) == "planar"


@pytest.mark.parametrize("grad", [False, True])
def test_every_kernel_call_of_a_forward_takes_the_calls_layout(monkeypatch, grad):
    """f32 without autograd: every 4-D K1 and K3 call gets a planar view;
    with autograd: none does; and the image is contiguous either way."""
    cfg = config_f_shaped()
    g = generator(cfg)
    rec = Dispatch(monkeypatch)
    z = torch.randn(2, cfg.latent_dimensions, generator=torch.Generator().manual_seed(3))
    with torch.set_grad_enabled(grad):
        image = g(z, randomize_noise=False)
    want = {("K1", not grad): 2 * cfg.n_stages + 1, ("K3", not grad): 2 * cfg.n_stages}
    assert dict(rec.seen) == want
    assert image.is_contiguous() and image.shape == (2, 1, 3, 32, 32)


def test_bf16_training_iteration_sends_no_planar_tensor(monkeypatch):
    """A bf16 main step (its G forward without autograd for D included),
    then R1 and path length in f32 under autograd: every K1 and K3 call
    takes a channels_last view, and K2 and K4 see NHWC."""
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import StepFlags, TrainStep

    kw = dict(compute_dtype="bfloat16")
    g, d = Generator(tiny_generator_config(**kw)), Discriminator(tiny_discriminator_config(**kw))
    g.reset_parameters(torch.Generator().manual_seed(0))
    d.reset_parameters(torch.Generator().manual_seed(1))
    cfg = TrainingConfig(batch_size=2, ada_p_init=0.0)
    state = create_train_state(g, d, cfg)
    ts = TrainStep(cfg, top_k_start_iteration=0, top_k_final_iteration=4)
    rec = Dispatch(monkeypatch)
    grads = collections.Counter()
    f2 = fused_act._grad

    def k2(g_, *a, **k):
        if g_.dim() == 4:
            grads[fused_act.is_planar(g_)] += 1
        return f2(g_, *a, **k)

    monkeypatch.setattr(fused_act, "_grad", k2)
    draws = TorchDraws(torch.Generator().manual_seed(2))
    real = torch.rand((2, 2, 3, 32, 32), generator=torch.Generator().manual_seed(3))
    ts.main_step(state, real, StepFlags(wrong_order=True, do_cut_mix=True), draws)
    ts.r1_update(state, real)
    ts.path_length_update(state, draws)
    assert rec.seen[("K1", False)] > 0 and rec.seen[("K3", False)] > 0
    assert rec.seen[("K1", True)] == rec.seen[("K3", True)] == 0 and set(grads) == {False}


@pytest.mark.parametrize("shape", ["tiny", "config-F-shaped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_planar_forward_matches_channels_last(shape, seed):
    cfg = tiny_generator_config() if shape == "tiny" else config_f_shaped()
    g = generator(cfg, seed=seed)
    z = torch.randn(3, cfg.latent_dimensions, generator=torch.Generator().manual_seed(seed + 7))
    got, want = forward(g, z), forward(g, z, "channels_last")
    assert got.is_contiguous() and got.shape == want.shape
    assert peak_gap(got, want) < IMAGE_TOL


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (3, 5, 7, 3), (1, 1, 1, 16)])
def test_plain_fused_act_on_a_planar_view(shape):
    """The plain K1 on a planar view: the NHWC tensor's bits, in the
    planar layout (a 1 x 1 map is both layouts at once)."""
    rng = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=rng)
    bias = torch.randn(shape[-1], generator=rng)
    got = fused_act._forward(planar(x), bias, 0.2, 2 ** 0.5)
    assert torch.equal(got, fused_act.fused_leaky_relu_ref(x, bias, 0.2, 2 ** 0.5))
    assert got.permute(0, 3, 1, 2).is_contiguous()


@pytest.mark.parametrize("shape,up,pad", [
    ((2, 9, 9, 32), 1, (1, 1, 1, 1)), ((2, 16, 16, 8), 1, (2, 1, 2, 1)),
    ((2, 8, 8, 3), 2, (2, 1, 2, 1)), ((1, 7, 5, 3), 2, (3, 0, 1, 2)),
    ((2, 9, 11, 5), 1, (-1, 2, 0, 1))])
def test_plain_upfirdn2d_on_a_planar_view(shape, up, pad):
    rng = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=rng)
    taps = make_blur_kernel(gain=4.0 if up == 1 else 1.0)
    got = up_mod._upfirdn(planar(x), taps, up, 1, pad)
    want = up_mod.upfirdn2d_ref(x, taps, up, 1, (pad[2], pad[3], pad[0], pad[1]))
    assert got.permute(0, 3, 1, 2).is_contiguous() and got.shape == want.shape
    assert peak_gap(got, want) < K3_TOL


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sampling_sites_take_a_planar_tiled_variant(name):
    """Every K3 launch of both sampling configurations' f32 forward takes
    the planar tiled form of its (up, down), the C = 3 skips included, and
    every 4-D K1 launch gets a planar view."""
    cfg = bench_config(name)
    sites = sampling_sites(cfg, 16)
    k3 = [s for s in sites if s[0] == "K3"]
    assert len(k3) == 2 * cfg.n_stages  # the towers' sites coincide
    assert sum(sites[s] for s in k3) == 2 * cfg.n_stages * cfg.num_domains
    assert {s[1][-1] for s in k3 if s[2] == 2} == {cfg.sequence_length}
    for _, shape, up, down, pad in k3:
        code = up_mod._plan(shape, torch.float32, up, down, 4, 4, pad, (1 << 40, 4), planar=True)
        assert up_mod.VARIANTS[code] == f"planar-up{up}-down{down}", (shape, up, pad)
        # bf16 has no planar tiled form; it falls to the planar general one
        code = up_mod._plan(shape, torch.bfloat16, up, down, 4, 4, pad, (0, 0), planar=True)
        assert up_mod.VARIANTS[code] == "planar-general"


def test_census_reads_a_planar_launch_as_its_channels_last_twin(monkeypatch):
    """gpu_bench's census keys a launch by its (B, H, W, C) shape whatever
    its layout, so both layouts of one tensor give one key and one bound."""
    rng = torch.Generator().manual_seed(6)
    x = torch.randn((2, 9, 9, 32), generator=rng)
    bias = torch.randn(32, generator=rng)
    taps = make_blur_kernel(gain=4.0)
    keys = []
    for t in (x, planar(x)):
        with kernels.Census() as census:
            fused_act._forward(t, bias, 0.2, 1.0)
            up_mod._upfirdn(t, taps, 1, 1, (1, 1, 1, 1))
        keys.append(sorted(census.sites.items(), key=str))
    assert keys[0] == keys[1] and len(keys[0]) == 2
    assert [kernels.launch_bound_s(k) for k, _ in keys[0]] == \
        [kernels.launch_bound_s(k) for k, _ in keys[1]]


def test_every_kernel_name_is_one_the_benchmark_reads():
    """Each CUDA kernel of csrc/upfirdn2d.cu and each Triton kernel of K1
    holds a substring of gpu_bench.kernels.NAMES, so the roofline readers
    count its device time beside its bound."""
    cu = (ROOT / "multi_stylegan_torch" / "csrc" / "upfirdn2d.cu").read_text()
    py = Path(fused_act.__file__).read_text()
    cuda_names = re.findall(r"__global__[^{;]*?(\w+)\(const", cu)
    triton_names = re.findall(r"@triton\.jit\s+def (\w+)\(", py)
    assert "upfirdn2d_tiled_kernel_planar" in cuda_names and len(cuda_names) == 3
    assert triton_names == ["flr_fwd", "flr_fwd_planar"]
    for names, op in ((cuda_names, "upfirdn2d"), (triton_names, "fused_act")):
        for name in names:
            assert any(sub in name for sub in kernels.NAMES[op]), name


def test_counters_stay_at_zero_on_the_cpu():
    cfg = config_f_shaped()
    before = (fused_act.launches, fused_act.planar_launches, up_mod.launches,
              up_mod.planar_launches)
    forward(generator(cfg), torch.randn(2, cfg.latent_dimensions))
    assert (fused_act.launches, fused_act.planar_launches, up_mod.launches,
            up_mod.planar_launches) == before == (0, 0, 0, 0)


@pytest.mark.parametrize("planes,hw", [
    (16 * 512, 4 * 4), (16 * 32, 1024 * 1024), (128 * 512, 64 * 64), (130 * 512, 64 * 64),
    (256 * 512, 256 * 256), (5, 5000), (6, 49), (70000, 1)])
def test_planar_k1_grid_takes_any_number_of_planes(planes, hw):
    """flr_fwd_planar's grid is 1-D, as flr_fwd's, so any batch fits: 128
    and more at 512 channels pass the 65,535 a grid's second axis holds.
    Its programs' (band of planes, span of H*W) cover every element once."""
    programs, hw_blocks, block_p, block_hw = fused_act._planar_grid(planes, hw)
    assert programs < 2 ** 31 and block_p * block_hw == 4096
    bands = programs // hw_blocks
    assert programs == bands * hw_blocks
    assert (bands - 1) * block_p < planes <= bands * block_p
    assert (hw_blocks - 1) * block_hw < hw <= hw_blocks * block_hw
    if planes * hw <= 1 << 16:  # the kernel's index map, element by element
        pid = np.arange(programs)
        cols = (pid % hw_blocks)[:, None] * block_hw + np.arange(block_hw)
        rows = (pid // hw_blocks)[:, None] * block_p + np.arange(block_p)
        flat = (rows[:, :, None] * hw + cols[:, None, :])[
            (rows[:, :, None] < planes) & (cols[:, None, :] < hw)]
        assert np.array_equal(np.sort(flat), np.arange(planes * hw))


@pytest.mark.parametrize("dtype,grad,fmt,want", [
    (torch.float32, False, torch.contiguous_format, True),
    (torch.float32, False, torch.channels_last, False),
    (torch.float32, True, torch.contiguous_format, False),
    (torch.bfloat16, False, torch.contiguous_format, False)])
def test_fused_leaky_relu_module_follows_the_calls_layout(monkeypatch, dtype, grad, fmt, want):
    """FusedLeakyReLU, which D shares, sends K1 a planar view only where
    the call's layout is planar and its input already is: f32 without
    autograd; bf16, autograd or a channels_last input go channels_last."""
    rec = Dispatch(monkeypatch)
    x = torch.randn((2, 8, 5, 6), generator=torch.Generator().manual_seed(13))
    with torch.set_grad_enabled(grad):
        y = FusedLeakyReLU(8)(x.to(dtype).contiguous(memory_format=fmt))
    assert dict(rec.seen) == {("K1", want): 1}
    assert y.is_contiguous(memory_format=torch.contiguous_format if want else torch.channels_last)


GATHER_TIMEOUT_S = 120  # a hung collective fails the test instead of the suite's clock


def _gather_rank(rank, init, out):
    """One of two model ranks: gathers of a planar and a channels_last
    block, then the config-F-shaped generator's f32 forward without
    autograd, whole and sharded; writes ``rank<r>.pt``."""
    torch.set_num_threads(1)
    mesh.init(2, rank, init, torch.device("cpu"), timeout_s=GATHER_TIMEOUT_S, n_model=2)
    try:
        full = torch.randn((2, 8, 5, 6), generator=torch.Generator().manual_seed(0))
        result = {}
        for name, fmt in (("planar", torch.contiguous_format),
                          ("channels_last", torch.channels_last)):
            got = tp.gather(tp._block(full, 1).contiguous(memory_format=fmt))
            result[name] = (torch.equal(got, full), got.is_contiguous(memory_format=fmt))
        cfg = config_f_shaped()
        g = generator(cfg)
        z = torch.randn(2, cfg.latent_dimensions, generator=torch.Generator().manual_seed(1))
        want = forward(g, z)
        result["sharded"] = sorted(tp.shard_model(g))
        with pytest.MonkeyPatch.context() as mp:
            rec = Dispatch(mp)
            got = forward(g, z)
        result["seen"], result["gap"] = dict(rec.seen), peak_gap(got, want)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


def test_tensor_parallel_gather_keeps_the_planar_layout(tmp_path):
    """On two gloo model ranks the channel gather returns the layout it was
    given, so a sharded generator's f32 forward without autograd stays
    planar through its gathers: every K1 and K3 call gets a planar view,
    and the image is the one-process forward's."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_gather_rank, args=(r, init, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + GATHER_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    n_stages = config_f_shaped().n_stages
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        assert got["planar"] == got["channels_last"] == (True, True)
        assert any("modulated" in k or "conv" in k for k in got["sharded"]), got["sharded"]
        assert got["seen"] == {("K1", True): 2 * n_stages + 1, ("K3", True): 2 * n_stages}
        assert got["gap"] < IMAGE_TOL


# -------------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA and Triton kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_matches(x, bias):
    """The planar K1 on ``x``'s planar twin: NHWC K1's bits, in the planar
    layout, and the plain version's value."""
    want = fused_act._forward(x, bias, 0.2, 1.0)
    got = fused_act._forward(planar(x), bias, 0.2, 1.0)
    assert got.permute(0, 3, 1, 2).is_contiguous()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, fused_act.fused_leaky_relu_ref(x, bias, 0.2, 1.0),
                               rtol=1e-6, atol=1e-6)


def _k3_matches(xp, taps, up, pad, variant):
    """A planar K3 launch on ``xp`` (a planar view) against the plain
    version, within K3_TOL of the peak; the variant it took."""
    got = up_mod._upfirdn(xp, taps, up, 1, pad)
    assert up_mod.last_variant == variant
    assert got.permute(0, 3, 1, 2).is_contiguous()
    want = up_mod.upfirdn2d_ref(xp, taps, up, 1, (pad[2], pad[3], pad[0], pad[1]))
    assert peak_gap(got, want) < K3_TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_planar_kernels_match_plain_at_every_sampling_site(cuda, name):
    """K1 and K3 at every f32 sampling site of a configuration, at batch 16
    (config F's 16 x 32 x 1024^2 K1 and the 1025^2 blur input pass 2^31
    bytes; the C = 3 skips); K3 also against the NHWC tiled form's bits
    where that form takes the site."""
    cfg = bench_config(name)
    rng = torch.Generator(device=cuda).manual_seed(7)
    for site in sorted(sampling_sites(cfg, 16), key=str):
        if site[0] == "K1":
            x = torch.randn(site[1], generator=rng, device=cuda)
            _k1_matches(x, torch.randn(site[1][-1], generator=rng, device=cuda))
            continue
        _, shape, up, down, pad = site
        taps = site_taps(cfg, up, cuda)
        x = torch.randn((shape[0], shape[3], shape[1], shape[2]), generator=rng,
                        device=cuda).permute(0, 2, 3, 1)
        got = _k3_matches(x, taps, up, pad, f"planar-up{up}-down1")
        if shape[-1] % 4 == 0 and x.numel() * 4 < 2 ** 31:
            nhwc = up_mod._upfirdn(x.contiguous(), taps, up, 1, pad)
            assert up_mod.last_variant == f"up{up}-down1"
            assert torch.equal(got, nhwc)
        del x, got


@pytest.mark.cuda
def test_planar_kernels_take_more_planes_than_a_grid_axis(cuda):
    """Batch 130 at 512 channels: 66,560 planes of 64 x 64, more than the
    65,535 a grid's second axis holds (a sampling batch of 128 or more at
    the paper's widths)."""
    rng = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((130, 64, 64, 512), generator=rng, device=cuda)
    _k1_matches(x, torch.randn(512, generator=rng, device=cuda))
    xp = planar(x)
    del x
    _k3_matches(xp, make_blur_kernel(gain=4.0, device=cuda), 1, (2, 1, 2, 1), "planar-up1-down1")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,up,pad", [
    ((2, 9, 9, 5), 1, (1, 1, 1, 1)),        # odd map, C = 5
    ((2, 65, 65, 4), 1, (1, 1, 1, 1)),      # Wo 64: the narrow tile's widest
    ((2, 66, 67, 3), 1, (2, 1, 2, 1)),      # Wo 66: the wide tile, ragged, unaligned rows
    ((1, 20, 300, 2), 1, (3, 0, 0, 3)),     # H != W, asymmetric pads
    ((2, 9, 23, 3), 1, (-1, 2, 3, 0)),      # a crop
    ((2, 8, 8, 3), 2, (2, 1, 2, 1)),        # skip upsample
    ((3, 21, 45, 3), 2, (2, 1, 2, 1)),      # ragged width
    ((2, 9, 13, 2), 2, (1, 2, 2, 1)),       # odd y0, even x0
    ((2, 11, 9, 5), 2, (3, 0, 1, 2)),       # odd pads both ways
    ((1, 40, 70, 3), 2, (0, 3, 0, 3)),      # even pads, the wide tile
])
def test_planar_k3_edges_match_plain(cuda, shape, up, pad):
    rng = torch.Generator(device=cuda).manual_seed(8)
    taps = torch.randn((4, 4), generator=rng, device=cuda)
    x = torch.randn(shape, generator=rng, device=cuda)
    _k3_matches(planar(x), taps, up, pad, f"planar-up{up}-down1")


@pytest.mark.cuda
def test_planar_misaligned_views_and_the_general_form(cuda):
    """Planar views one element into their storage (no 16-byte vector
    store), bf16 (the planar general form), 3 x 3 taps (general) and
    K1 on misaligned and odd planes."""
    rng = torch.Generator(device=cuda).manual_seed(9)
    b, c, h, w = 2, 3, 16, 16
    flat = torch.randn(b * c * h * w + 1, generator=rng, device=cuda)
    xp = flat[1:].view(b, c, h, w).permute(0, 2, 3, 1)
    assert fused_act.is_planar(xp) and xp.data_ptr() % 16
    _k3_matches(xp, make_blur_kernel(gain=4.0, device=cuda), 2, (2, 1, 2, 1), "planar-up2-down1")
    _k3_matches(xp, make_blur_kernel(device=cuda), 1, (2, 1, 2, 1), "planar-up1-down1")
    taps3 = torch.randn((3, 3), generator=rng, device=cuda)
    _k3_matches(xp, taps3, 1, (1, 1, 1, 1), "planar-general")
    bf = planar(torch.randn((2, 9, 11, 5), generator=rng, device=cuda)).to(torch.bfloat16)
    got = up_mod._upfirdn(bf, make_blur_kernel(device=cuda), 2, 1, (2, 1, 2, 1))
    assert up_mod.last_variant == "planar-general" and fused_act.is_planar(got)
    torch.testing.assert_close(got.float(), up_mod.upfirdn2d_ref(
        bf, make_blur_kernel(device=cuda), 2, 1, (2, 1)).float(), rtol=2e-2, atol=2e-2)
    _k1_matches(xp.contiguous(), torch.randn(c, generator=rng, device=cuda))
    x = torch.randn((3, 7, 5, 6), generator=rng, device=cuda)
    _k1_matches(x, torch.randn(6, generator=rng, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["tiny", "config-F-shaped", "config F"])
def test_planar_generator_forward_matches_channels_last_on_the_card(cuda, shape):
    if shape == "config F":
        cfg, batch = bench_config("sg2f1024"), 2
    else:
        cfg, batch = (tiny_generator_config() if shape == "tiny" else config_f_shaped()), 4
    g = generator(cfg, cuda)
    z = torch.randn(batch, cfg.latent_dimensions, generator=torch.Generator().manual_seed(11))
    got, want = forward(g, z.to(cuda)), forward(g, z.to(cuda), "channels_last")
    assert got.is_contiguous()
    assert peak_gap(got, want) < IMAGE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_planar_launches_count_every_launch_of_a_sampling_forward(cuda, name):
    """Every K3 launch of a sampling forward is planar, and every K1 launch
    but the mapping network's (on [B, 512])."""
    cfg = bench_config(name)
    sites = sampling_sites(cfg, 2)
    g = generator(cfg, cuda)
    z = torch.randn(2, cfg.latent_dimensions, device=cuda)
    before = (fused_act.launches, fused_act.planar_launches, up_mod.launches,
              up_mod.planar_launches)
    with torch.inference_mode():
        g(z, randomize_noise=False)
    k1, k1p, k3, k3p = (a - b for a, b in zip((fused_act.launches, fused_act.planar_launches,
                                              up_mod.launches, up_mod.planar_launches), before))
    spatial = sum(n for s, n in sites.items() if s[0] == "K1")
    assert (k1p, k3p) == (spatial, sum(n for s, n in sites.items() if s[0] == "K3"))
    assert k1 == spatial + cfg.depth_style_mapping and k3 == k3p


@pytest.mark.cuda
def test_a_training_iteration_launches_nothing_planar(cuda):
    """The bf16 main step (cut-mix and wrong order on), R1 and path length
    (f32 under autograd): every K1 and K3 launch takes the NHWC forms."""
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import StepFlags, TrainStep

    kw = dict(compute_dtype="bfloat16")
    g, d = Generator(tiny_generator_config(**kw)), Discriminator(tiny_discriminator_config(**kw))
    g.reset_parameters(torch.Generator().manual_seed(0))
    d.reset_parameters(torch.Generator().manual_seed(1))
    cfg = TrainingConfig(batch_size=4, ada_p_init=0.0)
    state = create_train_state(g.to(cuda), d.to(cuda), cfg)
    ts = TrainStep(cfg, top_k_start_iteration=0, top_k_final_iteration=4)
    draws = TorchDraws(torch.Generator(device=cuda).manual_seed(2))
    real = torch.rand((4, 2, 3, 32, 32), generator=torch.Generator().manual_seed(3)).to(cuda)
    before = (fused_act.launches, up_mod.launches, fused_act.planar_launches,
              up_mod.planar_launches)
    ts.main_step(state, real, StepFlags(wrong_order=True, do_cut_mix=True), draws)
    ts.r1_update(state, real)
    ts.path_length_update(state, draws)
    torch.cuda.synchronize()
    k1, k3, k1p, k3p = (a - b for a, b in zip((fused_act.launches, up_mod.launches,
                                              fused_act.planar_launches,
                                              up_mod.planar_launches), before))
    assert k1 > 0 and k3 > 0 and (k1p, k3p) == (0, 0)
    assert np.isfinite(float(state.mean_path_length))
