"""Driver of the StyleGAN2 sampling cells: the sampling CLI's loop
(``multi_stylegan_torch/cli/sample.py``) with the port's generator built
from a StyleGAN2 configuration (one tower, k3 up-convs, skip gain 4, a toRGB
bias per channel), at a fixed batch, one client in a closed loop: draw z,
``generator(z, generator=rng)`` under ``inference_mode``, copy the images to
host memory through the CLI's pinned buffer (``HostCopy``); no file writes.

As ``drivers/sample.py`` (whose seeds and image gap it shares), but
``correct`` holds the kept batches against the plain StyleGAN2 reference
(``reference/stylegan2.py``: per-sample weights, grouped convolutions), and
the model FLOPs are counted on that reference.

    python3 -m gpu_bench.drivers.sample_stylegan2 --workload <cell> --seeds 12 \\
        --control 3 --faults 3 --out cal.jsonl

calibrates ``correct``'s limit (``calibrate.py``'s readings: the program on
many seeds, the TF32 control and the faults on a few).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gpu_bench import flops, kernels
from gpu_bench.drivers.sample import image_gap, seeds
from gpu_bench.reference.stylegan2 import Generator as Reference
from gpu_bench.reference.stylegan2 import StyleGAN2Config
from gpu_bench.reference.weights import make_weights


def build(ctx):
    """The port's generator at the cell's configuration, weights from the seed."""
    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.utils.precision import pin_f32

    from gpu_bench.bench import port_configs

    pin_f32()
    gen = Generator(port_configs(ctx.config, **ctx.overrides)[0], device=ctx.device)
    make_weights([gen], seeds(ctx.seed)["weights"])
    return gen.eval()


def run(ctx) -> dict:
    from multi_stylegan_torch.cli.sample import HostCopy

    t, dev = ctx.traffic, ctx.device
    gen = build(ctx)
    to_host = HostCopy()
    s = seeds(ctx.seed)
    rng = torch.Generator(device=dev).manual_seed(s["draws"])
    pick = np.random.default_rng(s["check"])
    batch, dim = t["batch"], gen.config.latent_dimensions

    def sample() -> np.ndarray:
        z = torch.randn((batch, dim), generator=rng, device=dev)
        return to_host(gen(z, generator=rng))  # waits for the device

    kept, batch_ms = [], []
    census = kernels.Census() if ctx.trace else None
    with torch.inference_mode():
        for _ in range(t["warmup_batches"]):
            shape = sample().shape
        # host memory for the kept batches, touched before the window: a kept
        # batch is one copy there, as the CLI's buffer takes the next batch
        slots = torch.zeros((t["check_max"], *shape))
        counters0 = kernels.launch_counters()
        with ctx.window():
            if census:
                census.__enter__()
            try:
                while True:
                    keep = not batch_ms or (len(kept) < t["check_max"]
                                            and pick.random() < 1.0 / t["check_one_in"])
                    state = rng.get_state() if keep else None
                    t0 = time.perf_counter()
                    images = sample()
                    batch_ms.append((time.perf_counter() - t0) * 1e3)
                    if keep:
                        slot = slots[len(kept)]
                        kept.append((state, slot.copy_(torch.from_numpy(images)).numpy()))
                    if (len(batch_ms) >= t["trace_batches"] if ctx.trace
                            else ctx.elapsed() >= ctx.seconds):
                        break
            finally:
                if census:
                    census.__exit__(None, None, None)
    window_s = ctx.window_seconds
    peak = ctx.memory_peak()
    n = len(batch_ms)
    readings = {}
    if ctx.trace:
        readings.update(
            census=dict(census.sites), launches=census.launches(),
            counters={k: v - counters0[k] for k, v in kernels.launch_counters().items()},
            window_s=window_s,
            model_flops=flops.add(sampling_flops(ctx, batch), weights=[n]))
    del gen
    ctx.free_device()
    t0 = time.perf_counter()
    gap = reference_gap(ctx, kept)
    ctx.phases["reference_s"] = time.perf_counter() - t0
    return {"attempted": n, "failed": 0, "numbers": {"image_gap": gap}, "peak": peak,
            "end_to_end": {"sample_seqs_per_s": n * batch / window_s,
                           "sample_batch_ms_p90": float(np.percentile(batch_ms, 90))},
            "readings": readings, "sequences": n * batch, "checked": len(kept)}


def sampling_flops(ctx, batch: int) -> Dict[str, int]:
    """FLOPs of one batch (mapping and synthesis, the forward, the FIR
    filters' depthwise convolutions included) on the plain reference, on the
    ``meta`` device."""
    meta = torch.device("meta")
    ref = Reference(StyleGAN2Config.from_block(ctx.config_with_overrides()["generator"]),
                    device=meta)
    z = torch.zeros((batch, ref.cfg.latent_dimensions), device=meta)
    noise = [torch.zeros((batch, 1, h, w), device=meta) for h, w in ref.noise_shapes()]
    with torch.no_grad():
        return flops.count(lambda: ref(z, noise=noise))


def reference_gap(ctx, kept, tf32: bool = False) -> float:
    """The widest image gap over the kept batches, against the plain
    reference in f32 with TF32 off (on with ``tf32``: the control)."""
    dev = ctx.device
    ref = Reference(StyleGAN2Config.from_block(ctx.config_with_overrides()["generator"]),
                    device=dev)
    make_weights([ref], seeds(ctx.seed)["weights"])
    ref.eval()
    rng = torch.Generator(device=dev)
    worst = 0.0
    prior = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            for state, images in kept:
                rng.set_state(state)
                z = torch.randn((images.shape[0], ref.cfg.latent_dimensions), generator=rng,
                                device=dev)
                worst = max(worst, image_gap(images, ref(z, generator=rng).cpu().numpy()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prior
    return worst


# ---------------------------------------------------------------- calibration


def readings(ctx, kinds: List[str], batches: int = 6) -> dict:
    """The image gaps of the program's batches, of the faults (the second
    half of each batch zero; one sample's RGB channels reversed) and of the
    TF32 control, for one seed."""
    gen = build(ctx)
    rng = torch.Generator(device=ctx.device).manual_seed(seeds(ctx.seed)["draws"])
    kept = []
    with torch.inference_mode():
        for _ in range(batches):
            state = rng.get_state()
            z = torch.randn((ctx.traffic["batch"], gen.config.latent_dimensions),
                            generator=rng, device=ctx.device)
            kept.append((state, gen(z, generator=rng).cpu().numpy()))
    del gen
    ctx.free_device()
    out = {"program": {"image_gap": reference_gap(ctx, kept)}}
    if "faults" in kinds:
        half = [(st, np.concatenate([im[: len(im) // 2], np.zeros_like(im[len(im) // 2:])]))
                for st, im in kept]
        out["half_batch"] = {"image_gap": reference_gap(ctx, half)}
        altered = [(st, np.concatenate([im[:1, :, ::-1], im[1:]])) for st, im in kept]
        out["altered"] = {"image_gap": reference_gap(ctx, altered)}
    if "control" in kinds:
        out["control"] = {"image_gap": reference_gap(ctx, kept, tf32=True)}
    ctx.free_device()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from gpu_bench import bench
    from gpu_bench.calibrate import SEED0
    from gpu_bench.run import Context

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
    cell = bench.find_cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    for i in range(max(args.seeds, args.control, args.faults)):
        seed = args.first + 7919 * i
        ctx = Context(cell, seed, 0.0, False, torch.device("cuda:0"), bench.OUT / cell.name)
        kinds = [k for k, n in (("control", args.control), ("faults", args.faults)) if i < n]
        line = json.dumps({"workload": cell.name, "seed": seed, **readings(ctx, kinds),
                           "device": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
