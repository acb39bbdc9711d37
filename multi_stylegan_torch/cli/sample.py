"""Sampling CLI of the PyTorch port (reference scripts/get_gan_samples.py:30-60).

Loads the EMA generator from a reference-format ``.pt`` (the published
6-key checkpoint, or what ``multi_stylegan_tpu.cli.export`` writes) or makes
random weights from ``--seed``, draws ``--samples`` samples with
p_mixed_noise = 0 and fresh random noise, and writes per-domain PNG strips.

    python -m multi_stylegan_torch.cli.sample --samples 32 --output samples
    python -m multi_stylegan_torch.cli.sample --tiny --device cpu

Runs on the GPU unless ``--device cpu`` is given; without CUDA it stops.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch

from multi_stylegan_torch.io.images import save_prediction
from multi_stylegan_torch.models.config import GeneratorConfig, tiny_generator_config
from multi_stylegan_torch.models.generator import Generator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", default="", type=str,
                        help="Reference-format .pt whose 'generator_ema' is "
                             "loaded. Empty = random weights from --seed.")
    parser.add_argument("--samples", default=100, type=int)
    parser.add_argument("--output", default="samples", type=str)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--tiny", default=False, action="store_true")
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


def load_generator(checkpoint: str, config: GeneratorConfig, device: torch.device,
                   seed: int = 0) -> Generator:
    """The EMA generator of a reference-format ``.pt``, or random weights
    drawn from ``seed`` when ``checkpoint`` is empty."""
    generator = Generator(config)
    if checkpoint:
        if not checkpoint.endswith(".pt"):
            raise ValueError(
                f"--checkpoint {checkpoint!r}: only reference-format .pt files "
                "are read by the port (orbax directories are not)")
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        generator.load_state_dict(ckpt["generator_ema"], strict=True)
    else:
        generator.reset_parameters(torch.Generator().manual_seed(seed))
    return generator.to(device).eval()


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the CLI; returns what it did (samples, seconds, finiteness)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    config = tiny_generator_config() if args.tiny else GeneratorConfig()
    generator = load_generator(args.checkpoint, config, device, args.seed)
    os.makedirs(args.output, exist_ok=True)

    rng = torch.Generator(device=device).manual_seed(args.seed)
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
            images = images.cpu().numpy()  # waits for the device
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
