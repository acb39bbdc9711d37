"""Training CLI of the PyTorch port (the JAX package's cli/train.py; flag
parity with reference train_multi_stylegan.py:4-28).

    python -m multi_stylegan_torch.cli.train --path_to_data /data/tlfm --epochs 100
    python -m multi_stylegan_torch.cli.train --synthetic --tiny --device cpu --epochs 1
    python -m multi_stylegan_torch.cli.train --synthetic --devices 2 --batch_size 24

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

Data and tensor parallelism (parallel/mesh.py, parallel/tensor.py): the
ranks form the JAX mesh of ``--devices`` data ranks by ``--model_parallel``
model ranks.  Each data rank trains on its rows of every global batch of
``--batch_size`` (which ``--devices`` must divide, as the JAX mesh requires;
the wrong-order and path-length rows, a quarter and a half of it, may fall
unevenly, a rank holding none); the ``--model_parallel``
ranks of a data row split the conv weights' output channels between them
(the JAX ``state_shardings`` rule).  ``--devices`` defaults to the visible
cards divided by ``--model_parallel``, or 1 under ``--device cpu``.  Without
the multi-host flags the CLI spawns the ``devices x model_parallel`` ranks
itself, rank r on ``cuda:(r mod cards)`` (NCCL when every rank has a card of
its own, gloo when they share one, gloo on the CPU).  With
``--coordinator_address host:port --num_processes N --process_id r`` this
process joins a TCP rendezvous as rank r of N, every rank of both axes (on
``cuda:(r mod cards)`` over NCCL, or the CPU over gloo).  Only rank 0 prints
and writes.
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
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.train.draws import ShardDraws, TorchDraws
from multi_stylegan_torch.train.loop import Trainer
from multi_stylegan_torch.utils.precision import pin_f32


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--devices", default=None, type=int,
                        help="Number of data-parallel ranks (default: every visible card, "
                             "1 under --device cpu); --batch_size is the global batch and "
                             "must divide over them (the wrong-order and path-length rows "
                             "need not).")
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="Tensor-parallel size: ranks that split each conv weight's "
                             "output channels (the JAX mesh's model axis).")
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
                        help="host:port of rank 0's TCP rendezvous (multi-host: every "
                             "process runs the same command with its own --process_id).")
    parser.add_argument("--num_processes", default=None, type=int,
                        help="Total number of ranks (multi-host).")
    parser.add_argument("--process_id", default=None, type=int,
                        help="This process's rank in [0, num_processes) (multi-host).")
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda', 'cuda:N' or 'cpu' (CPU runs the plain PyTorch "
                             "versions of the kernels and reads data in-process).")
    return parser


def world_size(args, device: torch.device) -> int:
    """The number of ranks the flags ask for: ``--devices`` data ranks by
    ``--model_parallel`` model ranks.  Raises ``ValueError`` on a layout
    that cannot run, before anything is written."""
    n_model = args.model_parallel
    if n_model < 1:
        raise ValueError(f"--model_parallel {n_model}: need at least one rank")
    multi_host = (args.coordinator_address, args.num_processes, args.process_id)
    if any(v is not None for v in multi_host):
        if any(v is None for v in multi_host):
            raise ValueError("--coordinator_address, --num_processes and --process_id "
                             "go together")
        if not 0 <= args.process_id < args.num_processes:
            raise ValueError(f"--process_id {args.process_id} outside [0, {args.num_processes})")
        if args.num_processes % n_model or args.devices not in (None, args.num_processes // n_model):
            raise ValueError(f"--num_processes {args.num_processes} differs from --devices "
                             f"{args.devices} x --model_parallel {n_model} (one rank per "
                             "process, every rank counted)")
        requested = args.num_processes // n_model
    else:
        requested = args.devices
    return mesh.data_ranks(requested, device, args.batch_size, n_model) * n_model


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
    """FID, FVD and IS on ``device`` at the metrics' default batch, or none
    when the weights are missing."""
    if args.no_validation_metrics:
        return ()
    from multi_stylegan_torch.eval.metrics import FID, FVD, IS, WeightsUnavailable

    # the metrics' own batch, as the JAX CLI builds them (not --batch_size)
    kw = dict(latent_dimensions=latent_dimensions, device=device)
    if data_samples is not None:
        kw["data_samples"] = data_samples
    try:
        return (FID(**kw), FVD(**kw), IS(**kw))
    except WeightsUnavailable as exc:
        print(f"Validation metrics disabled: {exc}")
        return ()


def load_checkpoint(trainer: Trainer, path: str, say=print) -> None:
    """Restore ``path`` into the trainer (on every rank): a directory of the
    port's checkpoints (the newest), one such file, or a reference-format
    .pt."""
    if os.path.isdir(path):
        if not trainer.restore_latest(path):
            raise FileNotFoundError(f"--load_checkpoint {path}: no checkpoint_<step>.pt there")
        say(f"Restored step {trainer.state.step} from {path}")
        return
    saved = read_checkpoint(path)
    if "train_state" in saved:
        trainer.load_payload(saved)
        say(f"Restored step {trainer.state.step} from {path}")
        return
    found = import_reference_checkpoint(trainer.state, saved)
    say(f"Loaded reference .pt checkpoint {path}: G, G-EMA, D and noise buffers"
          + "".join(f", {what}" for what in found)
          + ("" if {"G Adam", "D Adam"} <= set(found) else
             " (a missing Adam state starts fresh)"))


def main(argv: Optional[List[str]] = None, config_overrides: Optional[Dict[str, Any]] = None,
         validation_samples: Optional[int] = None) -> Dict[str, object]:
    """Run the CLI; returns what it did (steps, seconds, metrics, finiteness
    and, in one process, the trainer and its state; with several ranks
    spawned here, rank 0's steps, seconds, metrics and finiteness).  Python
    callers may override ``TrainingConfig`` fields the CLI has no flag for
    (e.g. ``checkpoint_every_n_epochs``) and the metrics' sample count."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    world = world_size(args, device)
    extra = (config_overrides, validation_samples)
    if args.coordinator_address is not None:
        return mesh.run_rank(lambda dev: train(args, dev, *extra), (), args.process_id, world,
                             f"tcp://{args.coordinator_address}", torch.device(args.device),
                             n_model=args.model_parallel)
    if world == 1:
        return train(args, device, *extra)
    return mesh.spawn(_spawned_rank, (args, *extra), world, device, n_model=args.model_parallel)


def summary(run: Dict[str, object]) -> Dict[str, object]:
    """What ``main`` returns of a run whose ranks it spawned (rank 0's): its
    steps, seconds, finiteness and history."""
    return {k: run[k] for k in ("steps", "seconds", "finite", "history")}


def _spawned_rank(device: torch.device, args, config_overrides: Optional[Dict[str, Any]],
                  validation_samples: Optional[int]) -> Dict[str, object]:
    """One rank ``main`` spawned (``parallel/mesh.py::spawn``): train, then
    the :func:`summary`."""
    return summary(train(args, device, config_overrides, validation_samples))


def train(args, device: torch.device, config_overrides: Optional[Dict[str, Any]] = None,
          validation_samples: Optional[int] = None) -> Dict[str, object]:
    """Train as this process's rank (rank 0 of 1 without a process group)."""
    writer = mesh.writes()
    say = print if writer else (lambda *a, **kw: None)
    pin_f32()
    say("Init models")
    generator, discriminator, cfg, dataset = build(args, device)
    cfg = dataclasses.replace(cfg, **(config_overrides or {}))
    say("Init dataset")
    workers = (0 if device.type == "cpu"
               else max(1, min(8, (os.cpu_count() or 1) // mesh.process_count())))
    loader = make_loader(dataset, cfg.batch_size, seed=args.seed, num_workers=workers,
                         device=device)
    say(f"{len(dataset)} sequences, {len(loader)} steps/epoch, {mesh.process_count()} "
        f"rank(s) ({mesh.world()} data x {mesh.model_world()} model)")
    if writer:
        logger = Logger(experiment_path=args.experiment_path)
        logger.log_hyperparameter(hyperparameter_dict=vars(args))
    # the other ranks log to rank 0's experiment (and write nothing there)
    path = mesh.broadcast_object(logger.experiment_path if writer else None)
    if not writer:
        logger = Logger(experiment_path=path)
    trap_map = (make_trap_weights_map(resolution=generator.config.resolution,
                                      inside_weight=args.trap_weight_inside)
                if args.trap_weights else None)
    draws = TorchDraws(torch.Generator(device=device).manual_seed(args.seed))
    if mesh.world() > 1:
        draws = ShardDraws(draws)
    trainer = Trainer(generator, discriminator, cfg, loader, draws, epochs=args.epochs,
                      data_logger=logger,
                      validation_metrics=validation_metrics(
                          args, generator.config.latent_dimensions, device, validation_samples),
                      trap_weights_map=trap_map, profile_dir=args.profile_dir)
    if args.load_checkpoint:
        load_checkpoint(trainer, args.load_checkpoint, say)

    def report(step, m):
        say(f"step {step}: loss D={m['loss_discriminator_real'] + m['loss_discriminator_fake']:.4f}"
            f" G={m['loss_generator']:.4f} ({m['seconds']:.2f} s)", flush=True)

    say("Start training")
    start = time.perf_counter()
    history = trainer.train(on_step=report)
    seconds = time.perf_counter() - start
    finite = all(math.isfinite(v) for m in history for v in m.values())
    peak = (f"; peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB on this rank"
            if device.type == "cuda" else "")
    say(f"Trained {len(history)} steps in {seconds:.1f} s{peak}")
    return {"steps": len(history), "seconds": seconds, "finite": finite,
            "history": history, "state": trainer.state, "trainer": trainer}


if __name__ == "__main__":
    main()
