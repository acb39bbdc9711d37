"""The reference regime's soak at batch 24 (the JAX package's
tools/soak_b24.py): the real ``Trainer`` path (data loader, logger,
checkpoints, validation metrics) at the flagship 256x256 config, batch 24
(reference train_multi_stylegan.py:7-8), bf16, full remat, on the teacher
fixture, for ``--epochs`` epochs of ``--steps_per_epoch`` steps in two
phases:

  phase A: a fresh Trainer for the first half of the epochs: R1, path
           length, cut-mix and ADA on their reference cadences, the sample
           grids each epoch, checkpoints into ``<workdir>/ckpt``, one
           reduced validation pass at the end of the phase.
  phase B: a new process and a new Trainer with ``resume_training``,
           restoring phase A's latest checkpoint from the same directory
           (the reference's --load_checkpoint and --resume_training: cut-mix
           probability 0.5, wrong order on, top-k collapsed,
           model_wrapper.py:121-123), for the second half, ending in another
           validation pass.  The restored step must be the latest saved one.

Both phases train on ``--devices`` data ranks, one process each: by
default every visible card under ``--device cuda`` (the JAX tool's
``make_mesh()`` puts every device of the host on the data axis) and one
rank under ``--device cpu`` or ``cuda:N``, by the training CLI's rule
(parallel/mesh.py::data_ranks).  Each rank trains on its rows of every
global batch of ``--batch``, which must divide over them (a host of 5 or
7 cards at batch 24 is refused, as the JAX mesh's batch sharding refuses
it), as in the training CLI, whose launcher (parallel/mesh.py::spawn)
starts them:
NCCL when each rank owns a card, gloo when ranks share one or run on the
CPU.  Global rank 0 draws the teacher fixture and broadcasts it (the record
keeps its digest), makes the logger and writes the grids, checkpoints and
the record; every rank takes part in the checkpoint's gather, runs the
validation metrics on the global batches (rank 0 alone takes the Frechet
distances and broadcasts them), restores phase A's checkpoint in phase B
and sweeps its own parameters.  ``--phase both`` (the default) starts each
phase's ranks anew, one phase after the other: a new process is the
reference's resume workflow, and it frees all of phase A's device memory
before phase B builds its state; the launching process touches no card.
One rank with ``--phase a`` or ``b`` runs in the calling process.  A rank
that fails fails its phase and the tool.

Writes a JSON with the JAX record's fields (``SOAK_B24.json``): the losses
and ADA's p and r, per-epoch sequences/s, events (checkpoints, the restore,
validation scores and walls, warnings), the NaN watch over every logged
metric and a final finiteness sweep over the parameters, plus each phase's
peak device memory (the writer's, and every rank's) and the restored step
(every rank's), the number of data ranks and their backend, and the
fixture's digest a phase.  The partial record is written after phase A.
``ok`` needs no non-finite metric, finite parameters on every rank, and
the final step the restored one plus phase B's steps; a rank that restores
another step than the one saved fails phase B.  A validation metric that
fails is recorded as an event and the soak goes on.

    python -m multi_stylegan_torch.tools.soak_b24 --out SOAK_B24_H100.json  # every card
    python -m multi_stylegan_torch.tools.soak_b24 --tiny --device cpu --dtype float32 \\
        --batch 4 --epochs 2 --steps_per_epoch 4 --val_samples 8 --val_batch 4 \\
        --out soak.json [--devices 2]

With ``--tiny`` the teacher is the 32px debug generator (other weights), as
in tools/stability_run.py.  ``--out`` defaults to another name than the JAX
tool's, whose default is the TPU record at the root of the repository.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from multi_stylegan_torch.parallel import mesh


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=50,
                    help="Total epochs over both phases (half each).")
    ap.add_argument("--steps_per_epoch", type=int, default=24)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--out", default="SOAK_B24_TORCH.json")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "soak_b24"))
    ap.add_argument("--val_samples", type=int, default=240,
                    help="Reduced validation sample count (the protocol is 5000: "
                         "tools/validation_run.py); random feature weights.")
    ap.add_argument("--val_batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:N' or 'cpu' (CPU runs the plain PyTorch "
                         "versions of the kernels).")
    ap.add_argument("--pl_start_tier", default=None,
                    help="Accepted and ignored: the JAX tool's start tier of the "
                         "path-length ladder, against a failed TPU compile that "
                         "costs minutes; here the ladder (train/robust.py) moves "
                         "down after one out-of-memory error.")
    ap.add_argument("--tiny", action="store_true", help="32px debug config.")
    ap.add_argument("--phase", default="both", choices=("both", "a", "b"),
                    help="'both' runs phase A, then phase B, each in processes of its own.")
    ap.add_argument("--profile_dir", default=None,
                    help="Write rank 0's torch.profiler trace (Chrome JSON) of phase A's "
                         "steps 2-5 there (the Trainer's profile window).")
    ap.add_argument("--devices", type=int, default=None,
                    help="Data ranks, a process each, one card each under --device cuda "
                         "(default: every visible card under --device cuda, else 1); "
                         "--batch must divide over them.")
    return ap


def data_ranks(args, device: torch.device) -> int:
    """The data ranks ``args`` ask for on ``device`` (the training CLI's
    rule, :func:`mesh.data_ranks`); raises ``ValueError`` when the batch
    does not divide over them."""
    return mesh.data_ranks(args.devices, device, args.batch, batch_flag="--batch")


def phase_config(args, resume: bool, epochs: int):
    """The ``TrainingConfig`` of a phase of ``epochs`` epochs: one reduced
    validation pass at its end, checkpoints every ``min(5, max(1, epochs //
    2))`` epochs."""
    from multi_stylegan_torch.models.config import TrainingConfig

    return TrainingConfig(batch_size=args.batch, epochs=args.epochs, compute_dtype=args.dtype,
                          resume_training=resume, seed=0, validate_every_n_epochs=epochs,
                          checkpoint_every_n_epochs=min(5, max(1, epochs // 2)))


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the soak (or one phase); returns the record as written."""
    from multi_stylegan_torch.cli.sample import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ranks = data_ranks(args, device)
    if args.phase != "both" and ranks == 1:
        return run_phase(device, args)
    for phase in ("a", "b") if args.phase == "both" else (args.phase,):
        report = mesh.spawn(run_phase, (argparse.Namespace(**{**vars(args), "phase": phase}),),
                            ranks, device)
    return report


def run_phase(device: torch.device, args) -> Dict[str, object]:
    """Phase ``args.phase`` as this process's rank on ``device``; returns
    the record (rank 0 writes it), with the warnings raised meanwhile among
    its events."""
    events: List[dict] = []
    show = warnings.showwarning

    def record_warning(message, category, filename, lineno, file=None, line=None):
        events.append({"event": "warning", "message": str(message)[:300]})
        show(message, category, filename, lineno, file, line)

    warnings.showwarning = record_warning
    try:
        return _run_phase(args, device, events)
    finally:
        warnings.showwarning = show


def _run_phase(args, device: torch.device, events: List[dict]) -> Dict[str, object]:
    from multi_stylegan_torch.data.pipeline import make_loader
    from multi_stylegan_torch.eval.metrics import FID, FVD, IS
    from multi_stylegan_torch.io.logger import Logger
    from multi_stylegan_torch.tools.stability_run import models, nonfinite_params, teacher_fixture
    from multi_stylegan_torch.tools.validation_run import recorded
    from multi_stylegan_torch.train.draws import ShardDraws, TorchDraws
    from multi_stylegan_torch.train.loop import Trainer
    from multi_stylegan_torch.utils.precision import pin_f32

    pin_f32()
    writer = mesh.writes()
    if args.phase == "a" and writer:
        shutil.rmtree(args.workdir, ignore_errors=True)
    mesh.barrier()
    ckpt_dir = os.path.join(args.workdir, "ckpt")
    half = args.epochs // 2
    if args.phase == "b" and os.path.exists(args.out):
        with open(args.out) as f:  # phase A's record, continued
            report = json.load(f)
        events[:0] = report["events"]
        report["events"] = events
    else:
        report = {
            "config": {"batch": args.batch, "dtype": args.dtype, "remat": "full",
                       "epochs": args.epochs, "steps_per_epoch": args.steps_per_epoch,
                       "fixture": "teacher", "val_samples": args.val_samples,
                       "tiny": args.tiny},
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "events": events, "nan_metrics": [], "ok": False,
        }
    report.update(data_ranks=mesh.world(), backend=mesh.backend())

    generator, discriminator = models(args, device, 0)
    gcfg = generator.config
    report["config"]["resolution"] = list(gcfg.resolution)
    fixture = teacher_fixture(gcfg, args.tiny, args.batch * args.steps_per_epoch, args.dtype,
                              min(args.batch, 8), device)
    digest = hashlib.sha256(fixture[:]).hexdigest() if writer else None
    metrics_kw = dict(batch_size=args.val_batch, data_samples=args.val_samples,
                      latent_dimensions=gcfg.latent_dimensions, allow_random_weights=True,
                      device=device)

    def build_trainer(resume: bool, epochs: int, tag: str) -> Trainer:
        # the other ranks log to rank 0's experiment and write nothing there
        logger = Logger(os.path.join(args.workdir, tag)) if writer else None
        path = mesh.broadcast_object(logger.experiment_path if writer else None)
        draws = TorchDraws(torch.Generator(device=device).manual_seed(0))
        trainer = Trainer(generator, discriminator, phase_config(args, resume, epochs),
                          make_loader(fixture, args.batch, seed=0, device=device),
                          ShardDraws(draws) if mesh.world() > 1 else draws,
                          epochs=epochs, data_logger=logger or Logger(path),
                          validation_metrics=tuple(recorded(m(**metrics_kw), events, guard=True)
                                                   for m in (FID, FVD, IS)),
                          checkpoint_dir=ckpt_dir,
                          profile_dir=args.profile_dir if tag == "phase_a" else None)
        if args.pl_start_tier:
            events.append({"event": f"{tag} pl start tier ignored", "tier": args.pl_start_tier,
                           "chunks": trainer.path_length.chunks})
        return trainer

    def harvest(trainer: Trainer, tag: str, wall_s: float) -> int:
        m = trainer.logger.metrics
        steps = len(m.get("loss_generator", ()))
        trace = [{"step": i, "g": m["loss_generator"][i], "d": m["loss_discriminator_real"][i],
                  "ada_p": m["ada_p"][i], "ada_r": m["ada_r"][i]}
                 for i in range(0, steps, max(1, steps // 40))]
        report["nan_metrics"].extend(
            f"{tag}/{name}" for name, vals in sorted(m.items())
            if not np.all(np.isfinite(np.asarray(vals, dtype=np.float64))))
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        report[tag] = {"steps": steps, "wall_s": wall_s,
                       "seqs_per_sec": m.get("seqs_per_sec", []), "trace": trace,
                       "loss_tail": trace[-3:], "peak_memory_bytes": peak,
                       "peak_memory_bytes_by_rank": mesh.gather_objects(peak),
                       "fixture_sha256": digest}
        return steps

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if args.phase == "a":
        trainer = build_trainer(False, half, "phase_a")
        events.append({"event": "phase A start"})
        trainer.train()
        events.append({"event": "phase A done", "pl_chunks": trainer.path_length.chunks})
        harvest(trainer, "phase_a", time.perf_counter() - t0)
        events.append({"event": "latest checkpoint", "step": trainer.ckpt.latest_step()})
        # a phase-B failure keeps phase A's evidence; phase B continues this file
        report["partial"] = "phase A complete"
        if writer:
            _write(args.out, report)
            print(json.dumps({"phase": "a", "steps": report["phase_a"]["steps"],
                              "checkpoint": trainer.ckpt.latest_step()}), flush=True)
        return report

    steps_a = (report.get("phase_a") or {}).get("steps", 0)
    trainer = build_trainer(True, args.epochs - half, "phase_b")
    saved_step = trainer.ckpt.latest_step()
    if not trainer.restore_latest():
        raise RuntimeError(f"phase B found no checkpoint in {ckpt_dir}")
    restored = mesh.gather_objects(trainer.state.step)
    events.append({"event": "restored", "step": restored[0]})
    if any(step != saved_step for step in restored):
        raise RuntimeError(f"phase B restored steps {restored} (by rank), the latest saved is "
                           f"{saved_step}")
    report["restored_step"], report["restored_step_by_rank"] = restored[0], restored
    trainer.train()
    events.append({"event": "phase B done", "pl_chunks": trainer.path_length.chunks})
    steps_b = harvest(trainer, "phase_b", time.perf_counter() - t0)
    bad_params = mesh.gather_objects(nonfinite_params(trainer.state))
    report["nonfinite_params"] = sorted({name for bad in bad_params for name in bad})[:20]
    report["nonfinite_params_by_rank"] = [len(bad) for bad in bad_params]
    report["final_step"] = trainer.state.step
    report.pop("partial", None)
    report["total_steps"] = steps_a + steps_b
    # a failed save in phase A means an earlier restore point: the expected
    # final step is that point plus phase B's work
    report["ok"] = (not report["nan_metrics"] and not report["nonfinite_params"]
                    and report["final_step"]
                    == restored[0] + (args.epochs - half) * args.steps_per_epoch)
    if writer:
        _write(args.out, report)
        print(json.dumps({k: report[k] for k in ("ok", "total_steps", "final_step")}),
              flush=True)
    return report


def _write(path: str, report: Dict[str, object]) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
