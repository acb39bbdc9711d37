"""Stability run of the port's trainer (the JAX package's
tools/stability_run.py): N steps through ``Trainer.train`` at the flagship
256x256 config, bf16 at batch 16 by default, so that the lazy R1 and
path-length branch runs inside the loop every 16th step; a NaN watch on
every step's metrics, a checkpoint at step N/2 restored into a fresh
trainer (other random weights), and a trace of the losses and ADA's p and r.
Writes a JSON shaped like the JAX record (``STABILITY_TEACHER.json``).

    python -m multi_stylegan_torch.tools.stability_run --fixture teacher \\
        --steps 300 --out stability_torch.json
    python -m multi_stylegan_torch.tools.stability_run --tiny --device cpu \\
        --dtype float32 --batch 4 --steps 17 --out /tmp/stability.json

With ``--tiny`` the teacher is the 32px debug generator (other weights),
not the fixture's 512-channel one.

The trainer keeps its own epoch schedule (cut-mix probability rising over
the epochs, wrong order in the last quarter, top-k over the middle half);
the resumed half starts that schedule again from its first epoch.  Sample
grids land in a temporary experiment directory, as every epoch of a run
writes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--out", default="STABILITY_TORCH.json")
    ap.add_argument("--fixture", default="teacher", choices=("blobs", "teacher"),
                    help="teacher: 'real' data from a frozen random generator "
                         "(a realizable target, balanced dynamics); blobs: the "
                         "synthetic fixture.")
    ap.add_argument("--tiny", action="store_true", help="32px debug config.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def models(args, device, seed: int):
    """(generator, discriminator) of ``args.tiny`` / ``args.dtype`` with the
    reference init from ``seed``, on ``device`` (full remat: the configs'
    default)."""
    from multi_stylegan_torch.cli.train import model_configs
    from multi_stylegan_torch.models.discriminator import Discriminator
    from multi_stylegan_torch.models.generator import Generator

    gcfg, dcfg = model_configs(args.tiny, compute_dtype=args.dtype)
    init = torch.Generator().manual_seed(seed)
    generator, discriminator = Generator(gcfg), Discriminator(dcfg)
    generator.reset_parameters(init)
    discriminator.reset_parameters(init)
    return generator.to(device), discriminator.to(device)


def teacher_fixture(gcfg, tiny: bool, n_samples: int, dtype: str, batch: int, device):
    """The teacher fixture at ``gcfg``'s resolution: the fixture's
    512-channel generator, or with ``tiny`` the debug config's own (other
    weights), to keep a debug run small.  Under several ranks global rank 0
    draws it and broadcasts it, so that every rank holds the same bits
    (draws on a card need not repeat bit for bit in another process)."""
    from multi_stylegan_torch.data.synthetic import TeacherTLFMDataset
    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.parallel import mesh

    drawn = None
    if mesh.process_index() == 0:
        teacher = None
        if tiny:
            teacher = Generator(dataclasses.replace(gcfg, remat=False))
            teacher.reset_parameters(torch.Generator().manual_seed(17))
            teacher = teacher.to(device)
        drawn = TeacherTLFMDataset(n_samples=n_samples, resolution=gcfg.resolution,
                                   compute_dtype=dtype, batch=batch, generator=teacher,
                                   device=device)
    return mesh.broadcast_object(drawn)


def nonfinite_params(state) -> List[str]:
    """The parameters of G, its EMA and D holding a non-finite value."""
    bad = []
    for group in ("generator", "g_ema", "discriminator"):
        for name, p in getattr(state, group).named_parameters():
            if not bool(torch.isfinite(p).all()):
                bad.append(f"{group}/{name}")
    return bad


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)

    from multi_stylegan_torch.cli.sample import resolve_device
    from multi_stylegan_torch.data.pipeline import make_loader
    from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset
    from multi_stylegan_torch.io.logger import Logger
    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.loop import Trainer
    from multi_stylegan_torch.utils.precision import pin_f32

    device = resolve_device(args.device)
    pin_f32()
    generator, discriminator = models(args, device, args.seed)
    res = generator.config.resolution
    if args.fixture == "teacher":
        fixture = teacher_fixture(generator.config, args.tiny, max(256, args.batch * 8),
                                  args.dtype, args.batch, device)
    else:
        fixture = SyntheticTLFMDataset(n_samples=max(64, args.batch * 4), resolution=res)
    loader = make_loader(fixture, args.batch, seed=args.seed, device=device)
    epochs = math.ceil(args.steps / len(loader))
    # the run checkpoints at N/2 itself, not on the epoch cadence
    cfg = TrainingConfig(batch_size=args.batch, seed=args.seed,
                         checkpoint_every_n_epochs=epochs + 1, validate_every_n_epochs=epochs + 1)
    half = args.steps // 2
    log_every = min(25, max(1, args.steps // 10))
    report: Dict[str, object] = {
        "config": {"steps": args.steps, "batch": args.batch, "dtype": args.dtype,
                   "resolution": list(res), "fixture": args.fixture},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "events": [], "nan_steps": [], "seqs_per_sec": None, "ok": False,
    }
    t_log, regularised, step_seconds = [], [], []

    def on_step(step: int, m: Dict[str, float]) -> None:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            report["nan_steps"].append({"step": step, "metrics": bad})
        if m["loss_discriminator_regularization"] > 0 or m["path_length"] > 0:
            regularised.append(step)
        step_seconds.append(m["seconds"])
        if step % log_every == 0 or step in (half, args.steps):
            t_log.append((step, time.perf_counter(), m["loss_generator"],
                          m["loss_discriminator_real"], m["ada_p"], m["ada_r"]))
            print(f"step {step}: G={m['loss_generator']:.3f} "
                  f"D={m['loss_discriminator_real']:.3f} ada_p={m['ada_p']:.3f} "
                  f"ada_r={m['ada_r']:.3f} ({m['seconds']:.2f} s)", flush=True)

    with tempfile.TemporaryDirectory(prefix="stability_") as tmp:
        def trainer(generator, discriminator, name):
            draws = TorchDraws(torch.Generator(device=device).manual_seed(args.seed))
            return Trainer(generator, discriminator, cfg, loader, draws, epochs=epochs,
                           data_logger=Logger(experiment_path=os.path.join(tmp, name)))

        first = trainer(generator, discriminator, "first")
        t0 = time.perf_counter()
        first.train(on_step, max_steps=half)
        first.save_checkpoint()
        report["events"].append(f"checkpointed at step {first.state.step}")
        # restore into a trainer around other random weights, the first one gone
        ckpt_dir = first.ckpt.root
        del first, generator, discriminator
        resumed = trainer(*models(args, device, args.seed + 1), "resumed")
        if not resumed.restore_latest(ckpt_dir) or resumed.state.step != half:
            raise RuntimeError(f"restore from {ckpt_dir} did not give step {half}")
        report["events"].append(f"restored at step {resumed.state.step}")
        resumed.train(on_step, max_steps=args.steps)
        wall = time.perf_counter() - t0
        state = resumed.state

    if len(t_log) >= 3:  # the steady tail, past the first logged window
        (i0, s0, *_), (i1, s1, *_) = t_log[1], t_log[-1]
        report["seqs_per_sec"] = args.batch * (i1 - i0) / (s1 - s0)
    report["wall_s"] = wall
    report["final_step"] = state.step
    report["regularised_steps"] = regularised
    report["step_seconds"] = step_seconds
    report["trace"] = [{"step": i, "g": g, "d": d, "ada_p": p, "ada_r": r}
                       for i, _, g, d, p, r in t_log]
    report["loss_tail"] = report["trace"][-4:]
    ps = [p for *_, p, _ in t_log]
    report["ada_p_range"] = [min(ps), max(ps)] if ps else None
    report["nonfinite_params"] = nonfinite_params(state)[:20]
    report["ok"] = (not report["nan_steps"] and not report["nonfinite_params"]
                    and state.step == args.steps)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in ("ok", "seqs_per_sec", "final_step", "wall_s")}))
    return report


if __name__ == "__main__":
    main()
