"""Validation at the paper's protocol (the JAX package's
tools/validation_run.py): ``Trainer.validation()`` -- FID, FVD and IS with
``allow_random_weights`` -- at the flagship 256x256 config with the
reference protocol, 5,000 real and 5,000 fake samples at batch 24, the EMA
generator sampling seeded latents (reference validation_metrics.py:164).
Random feature weights make the scores meaningless (no pretrained weights
are shipped); the run shows the evaluation's real workload, 15,000
generator samples and 20,000 Inception / I3D forwards, end to end on the
device and within its memory.

Writes a JSON with the JAX record's keys (``VALIDATION.json``): each
metric's wall-clock and the device memory before and after.  Prints a
``split`` line beside it: the seconds inside generator sampling, the
feature nets and the host Frechet distances (scipy's ``sqrtm``), each
timed between two device synchronisations, and the rest (the real
samples' loading and host copies); and the card's ``nvidia-smi`` line
where there is one.

    python -m multi_stylegan_torch.tools.validation_run --out VALIDATION_H100.json
    python -m multi_stylegan_torch.tools.validation_run --tiny --device cpu \\
        --dtype float32 --samples 8 --batch 4 --out validation.json

The real samples are ``SyntheticTLFMDataset`` sequences streamed in the
dataset's order.  ``--out`` defaults to another name than the JAX tool's,
whose default is the TPU record at the root of the repository.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="VALIDATION_TORCH.json")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--samples", type=int, default=5000)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:N' or 'cpu' (CPU runs the plain PyTorch "
                         "versions of the kernels).")
    ap.add_argument("--tiny", action="store_true",
                    help="32px config, samples capped at 32 and batch at 8 (tool smoke test)")
    ap.add_argument("--exp_dir", default=os.path.join(tempfile.gettempdir(),
                                                      "validation_run_exp"))
    return ap


def recorded(metric, events: List[dict], guard: bool = False):
    """``metric`` appending to ``events`` on each call its scores and
    wall-clock (``{"event": "validation FID", "scores": ..., "wall_s":
    ...}``); with ``guard`` a failure becomes a ``validation FID FAILED``
    event and ``inf`` scores instead of an exception, as the JAX soak's
    ``_guarded`` does.  Keeps the metric's type name, by which
    ``Trainer.validation`` logs."""
    name = type(metric).__name__

    class Recorded(type(metric)):
        def __init__(self):  # the state is copied from ``metric`` below
            pass

        def __call__(self, *a, **k):
            t0 = time.perf_counter()
            try:
                out = super().__call__(*a, **k)
            except Exception as exc:
                if not guard:
                    raise
                traceback.print_exc()
                events.append({"event": f"validation {name} FAILED",
                               "error": f"{type(exc).__name__}: {exc}"[:300]})
                return [math.inf] * 2
            events.append({"event": f"validation {name}",
                           "scores": [float(s) for s in np.atleast_1d(out)],
                           "wall_s": time.perf_counter() - t0})
            return out

    Recorded.__name__ = Recorded.__qualname__ = name
    wrapped = Recorded()
    wrapped.__dict__.update(metric.__dict__)
    return wrapped


class Clock:
    """Seconds spent inside wrapped callables by name, the device
    synchronised on entry and on exit, so that each share holds its own
    device work."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.seconds: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name: str, fn: Callable) -> Callable:
        def timed(*a, **k):
            self._sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self._sync()
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return timed


def memory_stats(device: torch.device) -> Dict[str, int]:
    """The allocator's bytes in use and their peak (the JAX record's
    ``bytes_in_use`` / ``peak_bytes_in_use``); none on the CPU."""
    if device.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(device)
    return {"bytes_in_use": s["allocated_bytes.all.current"],
            "peak_bytes_in_use": s["allocated_bytes.all.peak"]}


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, if there is one."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)

    from multi_stylegan_torch.cli.sample import resolve_device
    from multi_stylegan_torch.data.pipeline import make_loader
    from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset
    from multi_stylegan_torch.eval import metrics as metrics_mod
    from multi_stylegan_torch.eval.metrics import FID, FVD, IS
    from multi_stylegan_torch.io.logger import Logger
    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.tools.stability_run import models
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.loop import Trainer
    from multi_stylegan_torch.utils.precision import pin_f32

    device = resolve_device(args.device)
    pin_f32()
    generator, discriminator = models(args, device, 0)
    gcfg = generator.config
    samples, batch = args.samples, args.batch
    if args.tiny:
        samples, batch = min(samples, 32), min(batch, 8)
    cfg = TrainingConfig(batch_size=batch, compute_dtype=args.dtype)
    # enough real samples for one whole protocol pass, in the dataset's order
    workers = 0 if device.type == "cpu" else max(1, min(8, os.cpu_count() or 1))
    loader = make_loader(SyntheticTLFMDataset(n_samples=samples + batch,
                                              resolution=gcfg.resolution),
                         batch, shuffle=False, num_workers=workers, device=device)
    kw = dict(allow_random_weights=True, batch_size=batch, data_samples=samples,
              latent_dimensions=gcfg.latent_dimensions, device=device)
    events: List[dict] = []
    metrics = tuple(recorded(m(**kw), events) for m in (FID, FVD, IS))
    trainer = Trainer(generator, discriminator, cfg, loader,
                      TorchDraws(torch.Generator(device=device).manual_seed(0)), epochs=1,
                      data_logger=Logger(experiment_path=args.exp_dir),
                      validation_metrics=metrics)

    clock = Clock(device)
    trainer.sample = clock.wrap("generator_sampling", trainer.sample)
    for m in metrics:
        for name in ("features", "probabilities"):
            if hasattr(m, name):
                setattr(m, name, clock.wrap("feature_nets", getattr(m, name)))
    frechet = metrics_mod.frechet_distance
    metrics_mod.frechet_distance = clock.wrap("frechet_host", frechet)
    mem0 = memory_stats(device)
    try:
        t0 = time.perf_counter()
        trainer.validation()
        total_s = time.perf_counter() - t0
    finally:
        metrics_mod.frechet_distance = frechet
    mem1 = memory_stats(device)

    logged = {name: vals[-1] for name, vals in trainer.logger.metrics.items()
              if name.startswith(("FID", "FVD", "IS"))}
    result = {
        "protocol": {"real_samples": samples, "fake_samples": samples, "batch": batch,
                     "resolution": list(gcfg.resolution),
                     "weights": "random (no pretrained weights shipped; "
                                "scores are plumbing-only)"},
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": args.dtype,
        "total_wall_s": total_s,
        "per_metric_wall_s": {e["event"].split()[1]: e["wall_s"] for e in events},
        "scores": {k: float(v) for k, v in logged.items()},
        "memory_before": mem0,
        "memory_after": mem1,
        "best_fvd_tracked": trainer.best_fvd,
    }
    split = dict(clock.seconds)
    split["rest"] = total_s - sum(split.values())
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    card = card_line()
    if card:
        print(card)
    print("split", json.dumps(split))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
