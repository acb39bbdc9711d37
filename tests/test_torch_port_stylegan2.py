"""StyleGAN2 (config F) through the port's generator, on the CPU.

The port's one-tower generator with k3 up-convs, the skip upsample's gain 4
and a toRGB bias per channel against the plain StyleGAN2 reference
(``gpu_bench/reference/stylegan2.py``: per-sample weights and grouped
convolutions, rosinality's ``upfirdn2d_native``), both filled from one seed;
the blur padding of the up-conv; and the default (Multi-StyleGAN) config
unchanged against the frozen copy of the port's generator in
``gpu_bench/reference/generator.py``.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gpu_bench import bench
from gpu_bench.reference import generator as frozen
from gpu_bench.reference import stylegan2
from gpu_bench.reference.config import GeneratorConfig as FrozenConfig
from gpu_bench.reference.weights import make_weights
from multi_stylegan_torch.cli import sample
from multi_stylegan_torch.models.config import GeneratorConfig, tiny_generator_config
from multi_stylegan_torch.models.generator import Generator, ModulatedConv2d, OutputBlock
from multi_stylegan_torch.ops.blur import blur_padding, up_blur_padding

# 4 -> 32, the channels falling 32 -> 16 as config F's do past 64
TINY_F = dict(channels=(32, 32, 16, 16), latent_dimensions=32, depth_style_mapping=2,
              num_domains=1, up_kernel_size=3, skip_upsample_gain=4.0,
              rgb_bias_per_channel=True)
# f32 on both sides, the same products summed in another order (a grouped
# conv of per-sample weights against the input scaled by the style, a
# depthwise conv against upfirdn2d's tap sums) through 7 conv layers: a
# few ulps of the images' peak (~1e-7 relative each), 1e-5 with room
PEAK_RTOL = 1e-5
SEED = 2_700_000_011


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**overrides):
    block = {**TINY_F, **overrides}
    port = Generator(GeneratorConfig(**block)).eval()
    ref = stylegan2.Generator(stylegan2.StyleGAN2Config.from_block(block)).eval()
    make_weights([port], SEED)
    make_weights([ref], SEED)
    return port, ref


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_port_matches_the_plain_stylegan2():
    port, ref = _pair()
    assert [n for n, _ in port.named_parameters()] == [n for n, _ in ref.named_parameters()]
    z = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = port(z, generator=torch.Generator().manual_seed(2))
        theirs = ref(z, generator=torch.Generator().manual_seed(2))
    assert ours.shape == theirs.shape == (3, 1, 3, 32, 32)
    assert float(theirs.abs().max()) > 0.1
    assert _gap(ours, theirs) < PEAK_RTOL


def test_the_reference_tells_the_skip_gain():
    """The port at the skip gain of 1 misses the reference by far more than
    the tolerance: the comparison above holds the gain (a wrong kernel size
    or bias shape fails it already, as the seeded leaves no longer fit)."""
    port, _ = _pair(skip_upsample_gain=1.0)
    _, ref = _pair()
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        gap = _gap(port(z, generator=torch.Generator().manual_seed(4)),
                   ref(z, generator=torch.Generator().manual_seed(4)))
    assert gap > 100 * PEAK_RTOL


@pytest.mark.parametrize("k,pads", [(2, (2, 1)), (3, (1, 1))])
def test_up_blur_padding_gives_twice_the_size(k, pads):
    assert up_blur_padding(4, k) == pads
    if k == 2:  # the Multi-StyleGAN formula agrees only here
        assert blur_padding(4, 2, k) == pads
    conv = ModulatedConv2d(8, 4, k, 16, upsampling=True)
    make_weights([conv], SEED)
    y, _ = conv(torch.randn(2, 8, 5, 7), torch.randn(2, 16))
    assert y.shape == (2, 4, 10, 14)


@pytest.mark.parametrize("gain", [1.0, 4.0])
def test_skip_gain_and_bias_per_channel(gain):
    """A constant skip of 1 upsamples to ``gain`` / 4 inside the image, and
    each RGB channel adds its own bias."""
    block = OutputBlock(8, 3, 16, upsampling=True, modulation_mapping=True,
                        blur_taps=(1, 3, 3, 1), skip_gain=gain, bias_per_channel=True)
    assert tuple(block.bias.shape) == (1, 3, 1, 1)
    assert float(block.upsampling.kernel.sum()) == pytest.approx(gain)
    make_weights([block], SEED)
    with torch.no_grad():
        block.modulated_convolution.weight.zero_()
        block.bias.copy_(torch.tensor([1.0, 2.0, 3.0]).view(1, 3, 1, 1))
        y, _ = block(torch.randn(2, 8, 8, 8), torch.randn(2, 16), torch.ones(2, 3, 4, 4))
    inner = y[:, :, 2:-2, 2:-2]
    expect = torch.tensor([1.0, 2.0, 3.0]).view(1, 3, 1, 1) + gain / 4
    torch.testing.assert_close(inner, expect.expand_as(inner))


def test_default_config_unchanged():
    """Multi-StyleGAN: the same state-dict keys as the frozen copy of the
    port's two-tower generator, and its images but for the plain ops'
    order of summation (that copy's upfirdn2d sums shifted taps)."""
    block = dict(channels=(32, 32, 32, 32), latent_dimensions=32, depth_style_mapping=2)
    port = Generator(tiny_generator_config()).eval()
    ref = frozen.Generator(FrozenConfig(**block)).eval()
    assert list(port.state_dict()) == list(ref.state_dict())
    make_weights([port], SEED)
    make_weights([ref], SEED)
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ours = port(z, z.flip(0), generator=torch.Generator().manual_seed(6))
        theirs = ref(z, z.flip(0), generator=torch.Generator().manual_seed(6))
    assert ours.shape == (2, 2, 3, 32, 32)
    assert _gap(ours, theirs) < 1e-6


def test_config_f_file_builds_one_tower():
    """The benchmark's config-F file: one tower, 18 w slots and the
    published channels by resolution, min(16384 / 2^(log2 r - 1), 512)."""
    block = json.loads((bench.ROOT / "gpu_bench/configs/sg2f-ffhq1024-f32.json").read_text())[
        "generator"]
    cfg = GeneratorConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in block.items()})
    assert cfg.n_latents == 18 and cfg.resolution == (1024, 1024)
    assert cfg.channels == tuple(min(16384 // 2 ** (r - 1), 512) for r in range(2, 11))
    gen = Generator(cfg, device="meta")
    assert {k.split(".")[0] for k in gen.state_dict()} == {
        "style_mapping", "constant_input_1", "starting_convolution_1",
        "starting_output_block_1", "main_convolutions_1", "output_blocks_1", "noises"}
    # ~30 M parameters: G fits one card whole, nothing cut
    assert 29e6 < sum(p.numel() for p in gen.parameters()) < 31e6


def test_sampling_cli_takes_a_generator_config(tmp_path):
    """``cli/sample.py --generator_config``: a configuration file's
    ``generator`` block builds the one-tower generator, whose samples are
    one strip of the 3 RGB channels each."""
    path = tmp_path / "sg2.json"
    path.write_text(json.dumps({"name": "tiny-f", "generator": {
        **TINY_F, "channels": list(TINY_F["channels"])}}))
    out = tmp_path / "samples"
    run = sample.main(["--generator_config", str(path), "--device", "cpu", "--samples", "3",
                       "--batch_size", "2", "--output", str(out), "--seed", "1"])
    assert run["samples"] == 3 and run["finite"]
    assert sorted(os.listdir(out)) == [f"sample_{i}_bf_0.png" for i in range(3)]
    assert np.asarray(Image.open(out / "sample_2_bf_0.png")).shape == (32, 96, 3)
    with pytest.raises(ValueError, match="give one"):
        sample.main(["--tiny", "--generator_config", str(path), "--device", "cpu"])
