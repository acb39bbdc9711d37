"""The port's interpolation CLI against the JAX package's (CPU, tiny config),
its GIF writer, and the sampling CLI reading the port trainer's checkpoints.

Frames: both CLIs run the same weights (one reference-format .pt) on the
same anchors (the JAX CLI's draw, handed to the port) and write their
frames as PNGs; uint8 frames agree within 1 level (f32 on both sides, the
float-to-uint8 truncation may land one level apart).  The GIF holds each
frame within one palette step (255 / 127 levels) of its PNG.
"""

import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import multi_stylegan_tpu.io as jax_io
from multi_stylegan_tpu.cli import interpolate as jax_interpolate
from multi_stylegan_tpu.io.torch_convert import export_reference_checkpoint
from multi_stylegan_tpu.models import Discriminator as JaxDiscriminator
from multi_stylegan_tpu.models import Generator as JaxGenerator
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_g
from multi_stylegan_torch.cli import export as export_cli
from multi_stylegan_torch.cli import interpolate, sample
from multi_stylegan_torch.cli import train as train_cli
from multi_stylegan_torch.io.images import GIF_PALETTE, encode_gif, gif_indices
from multi_stylegan_torch.models.config import tiny_generator_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny-config work: the suite
    runs several worker processes on a few cores, and more threads only
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

FRAMES, BATCH = 10, 4


@pytest.mark.parametrize("anchors,frames", [(16, 1600), (16, 16), (5, 3), (3, 7), (1, 4)])
def test_linear_interpolate_latents_equals_jax(anchors, frames):
    a = np.random.default_rng(anchors).normal(size=(anchors, 8))
    np.testing.assert_array_equal(interpolate.linear_interpolate_latents(a, frames),
                                  jax_interpolate.linear_interpolate_latents(a, frames))


@pytest.fixture(scope="module")
def reference_pt(tmp_path_factory):
    """A tiny reference-format .pt from the JAX exporter, EMA weights
    perturbed so that every path carries signal."""
    gcfg, dcfg = jax_tiny_g(), jax_tiny_d()
    init = {"params": jax.random.key(0), "noise": jax.random.key(1), "mixing": jax.random.key(2)}
    v = jax.jit(JaxGenerator(gcfg).init)(init, jnp.zeros((1, gcfg.latent_dimensions)))
    rng = np.random.default_rng(0)
    ema = jax.tree.map(lambda a: np.asarray(a) + 0.2 * rng.normal(size=a.shape).astype(np.float32),
                       v["params"])
    d_shapes = jax.eval_shape(JaxDiscriminator(dcfg).init, jax.random.key(3),
                              jnp.zeros((1, 2, 3, 32, 32)))["params"]
    d_params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), d_shapes)
    path = tmp_path_factory.mktemp("interp") / "checkpoint.pt"
    torch.save(export_reference_checkpoint(v["params"], v["noises"], ema, d_params,
                                           g_config=gcfg, d_config=dcfg), path)
    return str(path)


def _png_frames(directory, n):
    return [np.asarray(Image.open(os.path.join(directory, f"frame_{i:05d}.png")).convert("RGB"))
            for i in range(n)]


@pytest.fixture(scope="module")
def both_runs(reference_pt, tmp_path_factory):
    """The JAX CLI and the port's on the same .pt and anchors, frames kept."""
    root = tmp_path_factory.mktemp("interp_runs")
    common = ["--checkpoint", reference_pt, "--tiny", "--frames", str(FRAMES), "--anchors", "4",
              "--batch_size", str(BATCH), "--fps", "25", "--keep_frames"]
    # the JAX sampler converts the .pt with the flagship discriminator config
    # (cli/sample.py:37); hand it the tiny one
    convert = functools.partial(jax_io.convert_reference_checkpoint, d_config=jax_tiny_d())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_io, "convert_reference_checkpoint", convert)
        jax_interpolate.main(common + ["--output", str(root / "jax"), "--seed", "3"])
    anchors = np.asarray(jax.random.normal(jax.random.key(3), (4, 32)))
    run = interpolate.main(common + ["--output", str(root / "port"), "--device", "cpu"],
                           anchors=anchors)
    return root, run


def test_frames_match_jax_within_one_level(both_runs):
    root, run = both_runs
    assert run["finite"] and run["frames"] == FRAMES
    ours, ref = _png_frames(root / "port", FRAMES), _png_frames(root / "jax", FRAMES)
    assert ours[0].shape == (32, 64, 3)
    assert len({f.tobytes() for f in ref}) == FRAMES  # the latents move the frames
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, i
    # the tones the palette assumes: BF grey, GFP green
    a = ours[0].astype(int)
    assert (a[:, :32, 0] == a[:, :32, 1]).all() and (a[:, 32:, 0] == 0).all()


def test_main_returns_its_latents_and_first_batch(both_runs):
    """The latents the CLI fed the generator and its first batch of images,
    which the chip smoke holds against the CPU: exactly the interpolated
    anchors and the images of the first PNG frames."""
    root, run = both_runs
    anchors = np.asarray(jax.random.normal(jax.random.key(3), (4, 32)), np.float64)
    np.testing.assert_array_equal(
        run["latents"], interpolate.linear_interpolate_latents(anchors, FRAMES).astype(np.float32))
    assert run["first_batch"].shape == (BATCH, 2, 3, 32, 32)
    np.testing.assert_array_equal(interpolate.interpolation_frames(run["first_batch"]),
                                  np.stack(_png_frames(root / "port", BATCH)))


def test_gif_decodes_to_the_frames(both_runs):
    """The port's GIF, read by PIL: frame count, size, delay, looping, and
    each frame within one palette step of the PNG of the same frame."""
    root, run = both_runs
    im = Image.open(run["gif"])
    assert im.n_frames == FRAMES and im.size == (64, 32)
    assert im.info["duration"] == 40 and im.info["loop"] == 0
    for i, want in enumerate(_png_frames(root / "port", FRAMES)):
        im.seek(i)
        got = np.asarray(im.convert("RGB")).astype(int)
        assert np.abs(got - want).max() <= 255 / 127, i


def test_gif_encoder_round_trips_through_pil():
    """LZW across table resets (a 12-bit table fills on noise), runs of one
    value, and both tones; PIL decodes the exact palette colours."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, size=(70, 90), dtype=np.uint8),
              np.full((70, 90), 200, np.uint8), (np.arange(70 * 90) % 256).reshape(70, 90)]
    data = encode_gif(frames, fps=60)
    im = Image.open(io.BytesIO(data))
    assert im.n_frames == 3 and im.info["duration"] == 20
    for i, f in enumerate(frames):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), GIF_PALETTE[f])
    v = np.arange(256, dtype=np.uint8)[None].repeat(2, 0)
    grey = np.stack([v, v, v], -1)
    green = np.stack([0 * v, v, 0 * v], -1)
    for rgb in (grey, green):
        assert np.abs(GIF_PALETTE[gif_indices(rgb)].astype(int) - rgb).max() <= 1


def test_sample_cli_reads_the_port_trainers_checkpoints(tmp_path):
    """The sampling CLI takes the EMA generator of ``checkpoint_<step>.pt``,
    of its models directory (the newest step) and of the reference .pt that
    cli/export.py writes from it, bitwise, noise buffers included."""
    exp = tmp_path / "exp"
    run = train_cli.main(["--tiny", "--synthetic", "--device", "cpu", "--epochs", "1",
                          "--batch_size", "16", "--no_validation_metrics",
                          "--experiment_path", str(exp)],
                         config_overrides=dict(checkpoint_every_n_epochs=1))
    assert run["steps"] == 4
    models = exp / "models"
    assert os.listdir(models) == ["checkpoint_4.pt"]
    want = run["state"].g_ema.state_dict()
    export_cli.main([str(models), str(tmp_path / "ref.pt"), "--tiny"])
    for source in (models, models / "checkpoint_4.pt", tmp_path / "ref.pt"):
        got = sample.load_generator(str(source), tiny_generator_config(), torch.device("cpu"))
        got = got.state_dict()
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=f"{source}: {k}")
    out = tmp_path / "samples"
    run = sample.main(["--tiny", "--device", "cpu", "--samples", "2", "--checkpoint",
                       str(models), "--output", str(out)])
    assert run["finite"] and len(os.listdir(out)) == 4
