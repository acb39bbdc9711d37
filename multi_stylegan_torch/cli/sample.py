"""Sampling CLI of the PyTorch port (reference scripts/get_gan_samples.py:30-60).

Loads the EMA generator, with its fixed noise buffers, from ``--checkpoint``:
a checkpoint of the port's trainer (``checkpoint_<step>.pt``, or a models
directory, whose newest is taken) or a reference-format ``.pt`` (the
published 6-key checkpoint, or what ``cli/export.py`` writes); or makes
random weights from ``--seed``.  Draws ``--samples`` samples with
p_mixed_noise = 0 and fresh random noise, and writes per-domain PNG strips.

    python -m multi_stylegan_torch.cli.sample --checkpoint exp/models --samples 32
    python -m multi_stylegan_torch.cli.sample --tiny --device cpu
    python -m multi_stylegan_torch.cli.sample \
        --generator_config gpu_bench/configs/sg2f-ffhq1024-f32.json --samples 16

``--generator_config`` builds the generator from a JSON file: a
``GeneratorConfig``'s fields, or a file whose ``generator`` block they are
(the benchmark's configuration files), e.g. StyleGAN2 config F (one tower,
whose 3 frames are the RGB channels).

Runs on the GPU unless ``--device cpu`` is given; without CUDA it stops.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from multi_stylegan_torch.io.checkpoint import read_checkpoint
from multi_stylegan_torch.io.images import save_prediction
from multi_stylegan_torch.io.reference import strip_prefixes
from multi_stylegan_torch.models.config import GeneratorConfig, tiny_generator_config
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.utils.precision import pin_f32


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", default="", type=str,
                        help="The port trainer's checkpoint_<step>.pt or models "
                             "directory (newest step), or a reference-format .pt; "
                             "its EMA generator is loaded. Empty = random weights "
                             "from --seed.")
    parser.add_argument("--samples", default=100, type=int)
    parser.add_argument("--output", default="samples", type=str)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--tiny", default=False, action="store_true")
    parser.add_argument("--generator_config", default="", type=str,
                        help="A JSON file of GeneratorConfig fields, or one with a "
                             "'generator' block of them; default the flagship config.")
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda', 'cuda:N' or 'cpu' (CPU runs the plain "
                             "PyTorch versions of the kernels).")
    return parser


def resolve_device(name: str) -> torch.device:
    """The device to run on; never falls back to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available. Pass --device cpu to "
            "sample on the CPU with the kernels' plain PyTorch versions."
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def ema_state_dict(checkpoint: str) -> Dict[str, torch.Tensor]:
    """The EMA generator's state dict (noise buffers included) in a checkpoint
    of the port's trainer (a file, or a models directory: its newest step)
    or in a reference-format .pt (``generator_ema``)."""
    saved = read_checkpoint(checkpoint)
    if "train_state" in saved:
        return saved["train_state"]["g_ema"]
    if "generator_ema" in saved:
        return strip_prefixes(saved["generator_ema"])
    raise ValueError(f"--checkpoint {checkpoint}: neither a checkpoint of the port's trainer "
                     "('train_state') nor a reference .pt ('generator_ema')")


def load_generator(checkpoint: str, config: GeneratorConfig, device: torch.device,
                   seed: int = 0) -> Generator:
    """The EMA generator of ``checkpoint`` (see :func:`ema_state_dict`), or
    random weights drawn from ``seed`` when ``checkpoint`` is empty."""
    generator = Generator(config)
    if checkpoint:
        generator.load_state_dict(ema_state_dict(checkpoint), strict=True)
    else:
        generator.reset_parameters(torch.Generator().manual_seed(seed))
    return generator.to(device).eval()


class HostCopy:
    """Each batch's images in host memory through one pinned buffer, kept
    while the batch's shape holds: the copy from the card is a DMA at the
    link's rate, with no page faults of a fresh allocation (a pageable copy
    of a StyleGAN2 1024^2 batch of 16, 201 MB, took ~92 ms on an H100's
    host).  CPU images are returned as they are."""

    def __init__(self) -> None:
        self.buffer: Optional[torch.Tensor] = None

    def __call__(self, images: torch.Tensor) -> np.ndarray:
        """``images`` as a host array, valid until the next call (waits for
        the device)."""
        if images.device.type == "cpu":
            return images.numpy()
        if self.buffer is None or self.buffer.shape != images.shape:
            self.buffer = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
        return self.buffer.copy_(images).numpy()


def generator_config(path: str) -> GeneratorConfig:
    """The ``GeneratorConfig`` of a JSON file: its fields, or its
    ``generator`` block of them (lists become tuples)."""
    with open(path) as f:
        block = json.load(f)
    block = block.get("generator", block)
    return GeneratorConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in block.items()})


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the CLI; returns what it did (samples, seconds, finiteness)."""
    args = build_parser().parse_args(argv)
    if args.tiny and args.generator_config:
        raise ValueError("--tiny and --generator_config each choose the generator; give one")
    device = resolve_device(args.device)
    pin_f32()
    if args.generator_config:
        config = generator_config(args.generator_config)
    else:
        config = tiny_generator_config() if args.tiny else GeneratorConfig()
    generator = load_generator(args.checkpoint, config, device, args.seed)
    os.makedirs(args.output, exist_ok=True)

    rng = torch.Generator(device=device).manual_seed(args.seed)
    to_host = HostCopy()
    done = 0
    finite = True
    gen_seconds = 0.0
    start = time.perf_counter()
    with torch.inference_mode():
        while done < args.samples:
            n = min(args.batch_size, args.samples - done)
            t0 = time.perf_counter()
            z = torch.randn((n, config.latent_dimensions), generator=rng, device=device)
            # p_mixed_noise = 0: one latent (get_gan_samples.py:37-41)
            images = generator(z, generator=rng)
            finite = finite and bool(torch.isfinite(images).all())
            images = to_host(images)  # waits for the device
            gen_seconds += time.perf_counter() - t0
            for i in range(n):
                save_prediction(images[i:i + 1], args.output, f"sample_{done + i}")
            done += n
    seconds = time.perf_counter() - start
    print(f"Wrote {done} samples to {args.output} ({done / seconds:.2f} samples/s)")
    return {"samples": done, "seconds": seconds, "generate_seconds": gen_seconds,
            "finite": finite}


if __name__ == "__main__":
    main()
