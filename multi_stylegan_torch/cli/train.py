"""Training CLI of the PyTorch port (the JAX package's cli/train.py on one GPU;
flag parity with reference train_multi_stylegan.py:4-28).

    python -m multi_stylegan_torch.cli.train --path_to_data /data/tlfm --epochs 100
    python -m multi_stylegan_torch.cli.train --synthetic --tiny --device cpu --epochs 1

Trains the flagship config (``GeneratorConfig()``, ``DiscriminatorConfig(no_rfp=True)``,
``TrainingConfig()``: 256x256, 2 domains x 3 frames, batch 24, ADA and top-k
on, f32, remat on) from random weights drawn from ``--seed``, on a TLFM
TIFF tree (``--path_to_data``) or the synthetic fixture (``--synthetic``).
Writes the experiment directory of the JAX logger (metrics, hyperparameters,
sample grids, ``models/checkpoint_<step>.pt`` every 5 epochs), validates
with FID / FVD / IS every 10 epochs when the metric weights are found
(``MSG_TPU_INCEPTION_PT``, ``MSG_TPU_I3D_PT``) and traces steps 2-5 with
torch.profiler (``--profile_dir``).  ``--dtype bfloat16`` runs the D, cut-mix
and G steps in bf16 (R1 and path length stay f32); ``--ada_sequential_warps``
warps ADA's four affine stages one after another.  ``--load_checkpoint``
takes a directory of the port's checkpoints (its newest is restored), one
such file, or a reference-format ``.pt`` (the published checkpoint or
``cli/export.py``'s: G, G-EMA, D, the noise buffers and, when the file has
them, both Adam states and the path-length mean).  Runs on the GPU unless
``--device cpu`` is given; without CUDA it stops.

Not ported yet (they raise ``NotImplementedError`` naming the ROADMAP item):
more than one device and the multi-host flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Any, Dict, List, Optional

import torch

from multi_stylegan_torch.cli.sample import resolve_device
from multi_stylegan_torch.data.pipeline import make_loader
from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset
from multi_stylegan_torch.data.tlfm import TLFMDataset
from multi_stylegan_torch.data.trap_weights import make_trap_weights_map
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.io.checkpoint import read_checkpoint
from multi_stylegan_torch.io.reference import import_reference_checkpoint
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
from multi_stylegan_torch.utils.precision import pin_f32


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--devices", default=None, type=int,
                        help="Number of devices (the port trains on one; more is not ported).")
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="Tensor-parallel size (only 1 is ported).")
    parser.add_argument("--batch_size", default=24, type=int,
                        help="Batch size to be utilized while training.")
    parser.add_argument("--epochs", default=100, type=int,
                        help="Number of epochs to perform while training.")
    parser.add_argument("--lr_generator", default=2e-04, type=float,
                        help="Learning rate of the generator network.")
    parser.add_argument("--lr_discriminator", default=6e-04, type=float,
                        help="Learning rate of the discriminator network.")
    parser.add_argument("--path_to_data", default="./60x_10BF_200GFP_200RFP20_3Z_10min",
                        type=str, help="Path to the TLFM dataset (position folders of TIFFs).")
    parser.add_argument("--load_checkpoint", default="", type=str,
                        help="Directory of the port's checkpoint_<step>.pt files (an "
                             "experiment's models/; its newest is restored), one such "
                             "file, or a reference-format .pt.")
    parser.add_argument("--resume_training", default=False, action="store_true",
                        help="Resume: enables cut-mix/wrong-order/trap regimes immediately.")
    parser.add_argument("--no_top_k", default=False, action="store_true",
                        help="Disable top-k training.")
    parser.add_argument("--no_ada", default=False, action="store_true",
                        help="Disable adaptive discriminator augmentation.")
    parser.add_argument("--synthetic", default=False, action="store_true",
                        help="Train on the synthetic fixture dataset (no data needed).")
    parser.add_argument("--tiny", default=False, action="store_true",
                        help="Use the 32px debug config.")
    parser.add_argument("--experiment_path", default=None, type=str)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--compat_tower2_bug", default=False, action="store_true",
                        help="Reproduce the reference's tower-2 output-block wiring.")
    parser.add_argument("--no_validation_metrics", default=False, action="store_true",
                        help="Skip FID/FVD/IS validation (e.g. without pretrained weights).")
    parser.add_argument("--trap_weights", default=False, action="store_true",
                        help="Apply a trap-region pixel-weight map to the pixel losses "
                             "after trap_weight_start of training (data/trap_weights.py).")
    parser.add_argument("--trap_weight_inside", default=2.0, type=float,
                        help="Relative weight of the trap region (map normalized to mean 1).")
    parser.add_argument("--dtype", default="float32", type=str, choices=("float32", "bfloat16"),
                        help="Activation compute dtype of the D, cut-mix and G steps "
                             "(R1 and path length run in float32).")
    parser.add_argument("--no_remat", default=False, action="store_true",
                        help="Disable block rematerialization (more memory, faster backward).")
    parser.add_argument("--remat_min_px", default=0, type=int,
                        help="Selective remat: only blocks at >= this many pixels are "
                             "rematerialized (0 = all blocks).")
    parser.add_argument("--ada_sequential_warps", default=False, action="store_true",
                        help="The reference's four separate ADA warps instead of one "
                             "composed warp.")
    parser.add_argument("--ada_warp_fwd", default=None, type=str,
                        choices=("gather", "matmul", "matmul_unroll"),
                        help="Accepted and ignored: a TPU implementation choice of the "
                             "JAX package.")
    parser.add_argument("--platform", default=None, type=str,
                        help="Accepted and ignored: the JAX package's platform switch "
                             "(use --device).")
    parser.add_argument("--profile_dir", default=None, type=str,
                        help="Write a torch.profiler trace (Chrome JSON) of steps 2-5 "
                             "into this directory.")
    parser.add_argument("--coordinator_address", default=None, type=str,
                        help="Multi-host launch (not ported).")
    parser.add_argument("--num_processes", default=None, type=int,
                        help="Multi-host launch (not ported).")
    parser.add_argument("--process_id", default=None, type=int,
                        help="Multi-host launch (not ported).")
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda', 'cuda:N' or 'cpu' (CPU runs the plain PyTorch "
                             "versions of the kernels and reads data in-process).")
    return parser


def _refuse_unported(args) -> None:
    unported = [
        (args.devices not in (None, 1) or args.model_parallel != 1,
         "--devices / --model_parallel other than 1 (ROADMAP Queue 1: DDP)"),
        (any(v is not None for v in (args.coordinator_address, args.num_processes,
                                     args.process_id)),
         "multi-host launch (ROADMAP Queue 1: DDP)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"not ported yet: {what}")


def model_configs(tiny: bool, compat_tower2_bug: bool = False, **kw):
    """(generator, discriminator) configs: the 32px debug pair or the
    flagship (no-RFP discriminator), with ``kw`` set on both."""
    if tiny:
        return (tiny_generator_config(compat_tower2_output_bug=compat_tower2_bug, **kw),
                tiny_discriminator_config(**kw))
    return (GeneratorConfig(compat_tower2_output_bug=compat_tower2_bug, **kw),
            DiscriminatorConfig(no_rfp=True, **kw))


def build(args, device: torch.device):
    """(generator, discriminator, training config, dataset) for ``args``."""
    gcfg, dcfg = model_configs(args.tiny, args.compat_tower2_bug, compute_dtype=args.dtype,
                               remat=not args.no_remat, remat_min_px=args.remat_min_px)
    cfg = TrainingConfig(batch_size=args.batch_size, epochs=args.epochs,
                         lr_generator=args.lr_generator, lr_discriminator=args.lr_discriminator,
                         top_k=not args.no_top_k, ada=not args.no_ada,
                         ada_sequential_warps=args.ada_sequential_warps,
                         resume_training=args.resume_training, seed=args.seed)
    init = torch.Generator().manual_seed(args.seed)
    generator, discriminator = Generator(gcfg), Discriminator(dcfg)
    generator.reset_parameters(init)
    discriminator.reset_parameters(init)
    if args.synthetic:
        dataset = SyntheticTLFMDataset(n_samples=max(64, args.batch_size * 4),
                                       resolution=gcfg.resolution)
    elif not os.path.isdir(args.path_to_data):
        raise FileNotFoundError(f"--path_to_data {args.path_to_data}: no such directory "
                                "(pass --synthetic to train on the fixture)")
    else:
        dataset = TLFMDataset(path=args.path_to_data, no_rfp=True)
    return generator.to(device), discriminator.to(device), cfg, dataset


def validation_metrics(args, latent_dimensions: int, device: torch.device,
                       data_samples: Optional[int] = None) -> tuple:
    """FID, FVD and IS on ``device``, or none when the weights are missing."""
    if args.no_validation_metrics:
        return ()
    from multi_stylegan_torch.eval.metrics import FID, FVD, IS, WeightsUnavailable

    kw = dict(batch_size=args.batch_size, latent_dimensions=latent_dimensions, device=device)
    if data_samples is not None:
        kw["data_samples"] = data_samples
    try:
        return (FID(**kw), FVD(**kw), IS(**kw))
    except WeightsUnavailable as exc:
        print(f"Validation metrics disabled: {exc}")
        return ()


def load_checkpoint(trainer: Trainer, path: str) -> None:
    """Restore ``path`` into the trainer: a directory of the port's
    checkpoints (the newest), one such file, or a reference-format .pt."""
    if os.path.isdir(path):
        if not trainer.restore_latest(path):
            raise FileNotFoundError(f"--load_checkpoint {path}: no checkpoint_<step>.pt there")
        print(f"Restored step {trainer.state.step} from {path}")
        return
    saved = read_checkpoint(path)
    if "train_state" in saved:
        trainer.load_payload(saved)
        print(f"Restored step {trainer.state.step} from {path}")
        return
    found = import_reference_checkpoint(trainer.state, saved)
    print(f"Loaded reference .pt checkpoint {path}: G, G-EMA, D and noise buffers"
          + "".join(f", {what}" for what in found)
          + ("" if {"G Adam", "D Adam"} <= set(found) else
             " (a missing Adam state starts fresh)"))


def main(argv: Optional[List[str]] = None, config_overrides: Optional[Dict[str, Any]] = None,
         validation_samples: Optional[int] = None) -> Dict[str, object]:
    """Run the CLI; returns what it did (steps, seconds, metrics, finiteness,
    the trainer).  Python callers may override ``TrainingConfig`` fields the
    CLI has no flag for (e.g. ``checkpoint_every_n_epochs``) and the metrics'
    sample count."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    pin_f32()
    print("Init models")
    generator, discriminator, cfg, dataset = build(args, device)
    cfg = dataclasses.replace(cfg, **(config_overrides or {}))
    print("Init dataset")
    workers = 0 if device.type == "cpu" else min(8, os.cpu_count() or 1)
    loader = make_loader(dataset, cfg.batch_size, seed=args.seed, num_workers=workers,
                         device=device)
    print(f"{len(dataset)} sequences, {len(loader)} steps/epoch")
    logger = Logger(experiment_path=args.experiment_path)
    logger.log_hyperparameter(hyperparameter_dict=vars(args))
    trap_map = (make_trap_weights_map(resolution=generator.config.resolution,
                                      inside_weight=args.trap_weight_inside)
                if args.trap_weights else None)
    draws = TorchDraws(torch.Generator(device=device).manual_seed(args.seed))
    trainer = Trainer(generator, discriminator, cfg, loader, draws, epochs=args.epochs,
                      data_logger=logger,
                      validation_metrics=validation_metrics(
                          args, generator.config.latent_dimensions, device, validation_samples),
                      trap_weights_map=trap_map, profile_dir=args.profile_dir)
    if args.load_checkpoint:
        load_checkpoint(trainer, args.load_checkpoint)

    def report(step, m):
        print(f"step {step}: loss D={m['loss_discriminator_real'] + m['loss_discriminator_fake']:.4f}"
              f" G={m['loss_generator']:.4f} ({m['seconds']:.2f} s)", flush=True)

    print("Start training")
    start = time.perf_counter()
    history = trainer.train(on_step=report)
    seconds = time.perf_counter() - start
    finite = all(math.isfinite(v) for m in history for v in m.values())
    print(f"Trained {len(history)} steps in {seconds:.1f} s")
    return {"steps": len(history), "seconds": seconds, "finite": finite,
            "history": history, "state": trainer.state, "trainer": trainer}


if __name__ == "__main__":
    main()
