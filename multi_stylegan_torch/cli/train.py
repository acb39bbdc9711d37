"""Training CLI of the PyTorch port (flags of the JAX package's cli/train.py
that this slice runs).

    python -m multi_stylegan_torch.cli.train --synthetic --epochs 1
    python -m multi_stylegan_torch.cli.train --synthetic --tiny --device cpu --epochs 1

Trains the flagship config (``GeneratorConfig()``, ``DiscriminatorConfig(no_rfp=True)``,
``TrainingConfig()``: 256x256, 2 domains x 3 frames, batch 24, ADA and top-k
on, f32, remat on) from random weights drawn from ``--seed``, on the
synthetic fixture (``max(64, 4 x batch)`` sequences).  Runs on the GPU unless
``--device cpu`` is given; without CUDA it stops.  Real data, checkpoints,
sample grids and validation are not ported yet.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List, Optional

import torch

from multi_stylegan_torch.cli.sample import resolve_device
from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset
from multi_stylegan_torch.models.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.loop import Trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch_size", default=24, type=int)
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--synthetic", default=False, action="store_true",
                        help="Train on the synthetic fixture dataset (required: "
                             "the port reads no real data yet).")
    parser.add_argument("--tiny", default=False, action="store_true",
                        help="Use the 32px debug config.")
    parser.add_argument("--no_ada", default=False, action="store_true")
    parser.add_argument("--no_top_k", default=False, action="store_true")
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda', 'cuda:N' or 'cpu' (CPU runs the plain "
                             "PyTorch versions of the kernels).")
    return parser


def build(args, device: torch.device):
    """(generator, discriminator, training config, dataset) for ``args``."""
    if args.tiny:
        gcfg, dcfg = tiny_generator_config(), tiny_discriminator_config()
    else:
        gcfg, dcfg = GeneratorConfig(), DiscriminatorConfig(no_rfp=True)
    cfg = TrainingConfig(batch_size=args.batch_size, epochs=args.epochs,
                         top_k=not args.no_top_k, ada=not args.no_ada, seed=args.seed)
    init = torch.Generator().manual_seed(args.seed)
    generator, discriminator = Generator(gcfg), Discriminator(dcfg)
    generator.reset_parameters(init)
    discriminator.reset_parameters(init)
    dataset = SyntheticTLFMDataset(n_samples=max(64, args.batch_size * 4),
                                   resolution=gcfg.resolution)
    return generator.to(device), discriminator.to(device), cfg, dataset


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the CLI; returns what it did (steps, seconds, metrics, finiteness)."""
    args = build_parser().parse_args(argv)
    if not args.synthetic:
        raise ValueError("the port trains on --synthetic data only (the TLFM "
                         "loader is not ported yet)")
    device = resolve_device(args.device)
    generator, discriminator, cfg, dataset = build(args, device)
    draws = TorchDraws(torch.Generator(device=device).manual_seed(args.seed))
    trainer = Trainer(generator, discriminator, cfg, dataset, draws, epochs=args.epochs)
    start = time.perf_counter()

    def report(step, m):
        print(f"step {step}: loss D={m['loss_discriminator_real'] + m['loss_discriminator_fake']:.4f}"
              f" G={m['loss_generator']:.4f} ({m['seconds']:.2f} s)", flush=True)

    history = trainer.train(on_step=report)
    seconds = time.perf_counter() - start
    finite = all(math.isfinite(v) for m in history for v in m.values())
    print(f"Trained {len(history)} steps in {seconds:.1f} s")
    return {"steps": len(history), "seconds": seconds, "finite": finite,
            "history": history, "state": trainer.state}


if __name__ == "__main__":
    main()
