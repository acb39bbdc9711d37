"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process (not run by the benchmark's own runs):

* the program's numbers on many seeds (the lower reading);
* the control's (the reference one precision below the configuration's,
  ``control.py``) on a few seeds (the upper reading);
* each fault the cell can have, planted in the program, on a few seeds.

    python3 -m gpu_bench.calibrate --workload <cell> --seeds 12 --control 3 \\
        --faults 3 --out chiprun_out/cal.jsonl

Each reading is one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Iterator, List, Optional

from gpu_bench import bench, control

SEED0 = 2_300_000_000  # seeds above 2**31, as the driver's are


@contextlib.contextmanager
def half_batch_mean() -> Iterator[None]:
    """Fault: every batch mean of the port's losses taken over the first
    half of the rows only (the rest left out)."""
    from multi_stylegan_torch.parallel import mesh

    saved = mesh.global_mean

    def half(*xs):
        return saved(*(x[:max(1, x.shape[0] // 2)] for x in xs))

    mesh.global_mean = half
    try:
        yield
    finally:
        mesh.global_mean = saved


@contextlib.contextmanager
def top_k_choices(module) -> Iterator[List[list]]:
    """Records the rows each top-k mask of ``module`` (a losses module) keeps."""
    saved, seen = module.top_k_mask, []

    def record(prediction, v):
        mask, k = saved(prediction, v)
        seen.append(mask.reshape(mask.shape[0], -1)[:, 0].nonzero().flatten().tolist())
        return mask, k

    module.top_k_mask = record
    try:
        yield seen
    finally:
        module.top_k_mask = saved


def train_readings(ctx, kinds: List[str]) -> dict:
    """The numbers of the program (or a fault planted in it) and of the
    control against the reference, for one seed; with which top-k rows each
    side's G steps kept."""
    from multi_stylegan_torch.train import losses as port_losses

    from gpu_bench.drivers import train
    from gpu_bench.reference import losses as ref_losses

    out = {}
    fault = half_batch_mean() if "half_batch" in kinds else contextlib.nullcontext()
    with fault, top_k_choices(port_losses) as port_top:
        prog = train.Program(ctx)
        first, records, _ = prog.first_steps()
        n_g = len(list(prog.trainer.state.generator.parameters()))
        prog.free()
    ctx.free_device()
    with top_k_choices(ref_losses) as ref_top:
        ref = train.reference_steps(ctx, records, ctx.traffic["check_steps"])
    key = "half_batch" if "half_batch" in kinds else "program"
    out[key] = train.candidates(first, ref, n_g)
    out[key]["top_k_same"] = [a == b for a, b in zip(port_top, ref_top)]
    if "control" in kinds:
        with control.fp8_operands():
            ctl = train.reference_steps(ctx, records, ctx.traffic["check_steps"])
        out["control"] = train.candidates(ctl, ref, n_g)
    ctx.free_device()
    return out


def sample_readings(ctx, kinds: List[str], batches: int = 6) -> dict:
    """The image gaps of the program's batches (or faulty ones) and of the
    TF32 control, for one seed."""
    import numpy as np
    import torch

    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.utils.precision import pin_f32

    from gpu_bench.drivers import sample
    from gpu_bench.reference.weights import make_weights

    pin_f32()
    gcfg = bench.port_configs(ctx.config, **ctx.overrides)[0]
    s = sample.seeds(ctx.seed)
    gen = Generator(gcfg, device=ctx.device)
    make_weights([gen], s["weights"])
    gen.eval()
    rng = torch.Generator(device=ctx.device).manual_seed(s["draws"])
    kept = []
    with torch.inference_mode():
        for _ in range(batches):
            state = rng.get_state()
            z = torch.randn((ctx.traffic["batch"], gcfg.latent_dimensions), generator=rng,
                            device=ctx.device)
            kept.append((state, gen(z, generator=rng).cpu().numpy()))
    del gen
    ctx.free_device()
    out = {"program": {"image_gap": sample.reference_gap(ctx, gcfg, s["weights"], kept)}}
    if "half_batch" in kinds:
        bad = [(st, np.concatenate([im[: len(im) // 2], np.zeros_like(im[len(im) // 2:])]))
               for st, im in kept]
        out["half_batch"] = {"image_gap": sample.reference_gap(ctx, gcfg, s["weights"], bad)}
    if "altered" in kinds:  # one sample's frames in the wrong order
        bad = [(st, np.concatenate([im[:1, :, ::-1], im[1:]])) for st, im in kept]
        out["altered"] = {"image_gap": sample.reference_gap(ctx, gcfg, s["weights"], bad)}
    if "control" in kinds:
        out["control"] = {"image_gap": sample.reference_gap(ctx, gcfg, s["weights"], kept,
                                                            tf32=True)}
    ctx.free_device()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first", type=int, default=SEED0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(bench.OUT / "triton")
    import torch

    from gpu_bench.run import Context

    cell = bench.find_cell(args.workload)
    train = cell.traffic["driver"] == "train"
    faults = ["half_batch"] if train else ["half_batch", "altered"]
    sink = open(args.out, "a") if args.out else None
    for i in range(max(args.seeds, args.control, args.faults)):
        seed = args.first + 7919 * i
        ctx = Context(cell, seed, 0.0, False, torch.device("cuda:0"), bench.OUT / cell.name)
        kinds = (["program"] if i < args.seeds else []) + (
            ["control"] if i < args.control else [])
        readings = (train_readings if train else sample_readings)(ctx, kinds)
        if i < args.faults:
            for fault in faults:
                readings.update((train_readings if train else sample_readings)(ctx, [fault]))
        line = json.dumps({"workload": cell.name, "seed": seed, **readings})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
