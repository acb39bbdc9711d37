"""Latent-space interpolation CLI of the PyTorch port (the JAX package's
cli/interpolate.py; reference scripts/gan_latent_space_interpolation.py:28-62).

``--anchors`` latents are resampled linearly in z to ``--frames`` points,
which the EMA generator turns into sequences with its fixed noise buffers
(``randomize_noise=False``), ``--batch_size`` at a time.  Each frame is the
middle time step, BF grey beside GFP green; the frames go into
``<output>/interpolation.gif`` at ``--fps``, and with ``--keep_frames`` into
``frame_<i>.png`` files, which ``ffmpeg``, where it is on the PATH, turns
into ``interpolation.mp4``.

    python -m multi_stylegan_torch.cli.interpolate --checkpoint exp/models
    python -m multi_stylegan_torch.cli.interpolate --tiny --device cpu --frames 64

The anchors are drawn from a ``torch.Generator`` seeded with ``--seed``: the
port cannot reproduce JAX's PRNG, so the same seed gives other anchors than
the JAX CLI does (:func:`main` takes given anchors instead).  Runs on the
GPU unless ``--device cpu`` is given; without CUDA it stops.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from multi_stylegan_torch.cli.sample import load_generator, resolve_device
from multi_stylegan_torch.io.images import encode_gif, encode_png, gif_indices
from multi_stylegan_torch.models.config import GeneratorConfig, tiny_generator_config
from multi_stylegan_torch.utils.precision import pin_f32


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", default="", type=str,
                        help="The port trainer's checkpoint_<step>.pt or models directory, "
                             "or a reference-format .pt. Empty = random weights from --seed.")
    parser.add_argument("--anchors", default=16, type=int)
    parser.add_argument("--frames", default=1600, type=int)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--output", default="interpolation", type=str)
    parser.add_argument("--fps", default=60, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--tiny", default=False, action="store_true")
    parser.add_argument("--keep_frames", default=False, action="store_true")
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda', 'cuda:N' or 'cpu' (CPU runs the plain PyTorch "
                             "versions of the kernels).")
    return parser


def linear_interpolate_latents(anchors: np.ndarray, n_frames: int) -> np.ndarray:
    """[A, D] anchors resampled piecewise linearly to [n_frames, D], as
    ``F.interpolate(mode="linear", align_corners=False)`` over the anchor
    axis: frame i samples the anchors at (i + 0.5) A / n - 0.5, clamped."""
    a = anchors.shape[0]
    pos = np.clip((np.arange(n_frames) + 0.5) * a / n_frames - 0.5, 0, a - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, a - 1)
    t = (pos - lo)[:, None]
    return anchors[lo] * (1 - t) + anchors[hi] * t


def interpolation_frames(images: np.ndarray) -> np.ndarray:
    """[B, domains, T, H, W] images -> [B, H, 2W, 3] uint8 frames: the middle
    time step, BF as (v, v, v) beside GFP as (0, v, 0)."""
    mid = images.shape[2] // 2
    pane = np.concatenate([images[:, 0, mid], images[:, 1, mid]], axis=2)  # [B, H, 2W]
    bf = np.zeros(pane.shape[1:], pane.dtype)
    bf[:, : images.shape[-1]] = 1.0
    rgb = np.stack([pane * bf, pane, pane * bf], axis=-1)
    return np.clip(rgb * 255, 0, 255).astype(np.uint8)


def main(argv: Optional[List[str]] = None, anchors: Optional[np.ndarray] = None) -> Dict:
    """Run the CLI; returns what it did (frames, seconds, finiteness, the
    GIF's path), the latents it fed the generator and the images of its
    first batch.  ``anchors`` [A, D] replaces the seeded draw."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pin_f32()
    config = tiny_generator_config() if args.tiny else GeneratorConfig()
    generator = load_generator(args.checkpoint, config, device, args.seed)
    if anchors is None:
        anchors = torch.randn((args.anchors, config.latent_dimensions),
                              generator=torch.Generator().manual_seed(args.seed)).numpy()
    zs = linear_interpolate_latents(np.asarray(anchors, np.float64), args.frames)
    os.makedirs(args.output, exist_ok=True)

    indices, finite, gen_seconds, first_batch = [], True, 0.0, None
    start = time.perf_counter()
    with torch.inference_mode():
        for lo in range(0, args.frames, args.batch_size):
            t0 = time.perf_counter()
            z = torch.from_numpy(zs[lo:lo + args.batch_size]).float().to(device)
            images = generator(z, randomize_noise=False)
            finite = finite and bool(torch.isfinite(images).all())
            images = images.cpu().numpy()  # waits for the device
            if first_batch is None:
                first_batch = images
            gen_seconds += time.perf_counter() - t0
            for i, frame in enumerate(interpolation_frames(images)):
                indices.append(gif_indices(frame))
                if args.keep_frames:
                    with open(os.path.join(args.output, f"frame_{lo + i:05d}.png"), "wb") as f:
                        f.write(encode_png(frame))
    gif = os.path.join(args.output, "interpolation.gif")
    with open(gif, "wb") as f:
        f.write(encode_gif(indices, args.fps))
    seconds = time.perf_counter() - start
    print(f"Wrote {gif} ({len(indices)} frames, {len(indices) / seconds:.2f} frames/s)")
    if shutil.which("ffmpeg") and args.keep_frames:
        mp4 = os.path.join(args.output, "interpolation.mp4")
        subprocess.run(["ffmpeg", "-y", "-framerate", str(args.fps),
                        "-i", os.path.join(args.output, "frame_%05d.png"),
                        "-c:v", "libx264", "-pix_fmt", "yuv420p", mp4], check=False)
        print(f"Wrote {mp4}")
    return {"frames": len(indices), "seconds": seconds, "generate_seconds": gen_seconds,
            "finite": finite, "gif": gif, "latents": zs.astype(np.float32),
            "first_batch": first_batch}


if __name__ == "__main__":
    main()
