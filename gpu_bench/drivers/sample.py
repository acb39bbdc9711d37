"""Driver of the sampling cells: the sampling CLI's loop
(``multi_stylegan_torch/cli/sample.py``) at a fixed batch, one client in a
closed loop: draw z, ``generator(z, generator=rng)`` under
``inference_mode``, copy the images to host memory; no file writes.

A batch's time runs from its latent draw to its arrival in host memory.
Batches chosen from the seed (one in ``check_one_in``, at most
``check_max``, the window's first always) keep their output and the draw
generator's state before them; after the window the reference draws the
same z and noise from that state and synthesizes them again.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from gpu_bench import flops, kernels
from gpu_bench.reference.weights import make_weights


def seeds(seed: int) -> Dict[str, int]:
    w, d, c = np.random.SeedSequence([seed, 1]).generate_state(3, dtype=np.uint64)
    return {"weights": int(w), "draws": int(d), "check": int(c)}


def image_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The widest gap of a pixel, as a share of the reference's peak."""
    return float(np.abs(program - reference).max() / max(np.abs(reference).max(), 1e-30))


def run(ctx) -> dict:
    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.utils.precision import pin_f32

    from gpu_bench.bench import port_configs

    t, dev = ctx.traffic, ctx.device
    pin_f32()
    gcfg = port_configs(ctx.config, **ctx.overrides)[0]
    s = seeds(ctx.seed)
    gen = Generator(gcfg, device=dev)
    make_weights([gen], s["weights"])
    gen.eval()
    rng = torch.Generator(device=dev).manual_seed(s["draws"])
    pick = np.random.default_rng(s["check"])
    batch, dim = t["batch"], gcfg.latent_dimensions

    def sample() -> np.ndarray:
        z = torch.randn((batch, dim), generator=rng, device=dev)
        return gen(z, generator=rng).cpu().numpy()  # waits for the device

    forward_ms: List[float] = []

    def sample_timed() -> np.ndarray:
        z = torch.randn((batch, dim), generator=rng, device=dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        images = gen(z, generator=rng)
        end.record()
        out = images.cpu().numpy()
        forward_ms.append(start.elapsed_time(end))
        return out

    kept, batch_ms = [], []
    census = kernels.Census() if ctx.trace else None
    with torch.inference_mode():
        for _ in range(t["warmup_batches"]):
            sample()
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
                    images = sample_timed() if ctx.trace and dev.type == "cuda" else sample()
                    batch_ms.append((time.perf_counter() - t0) * 1e3)
                    if keep:
                        kept.append((state, images))
                    if (len(batch_ms) >= t["trace_batches"] if ctx.trace
                            else ctx.elapsed() >= ctx.seconds):
                        break
            finally:
                if census:
                    census.__exit__(None, None, None)
    window_s = ctx.window_seconds
    peak = ctx.memory_peak()
    readings = {}
    if ctx.trace:
        readings.update(
            g_forward_ms=statistics.fmean(forward_ms) if forward_ms else None,
            census=dict(census.sites), launches=census.launches(),
            counters={k: v - counters0[k] for k, v in kernels.launch_counters().items()},
            window_s=window_s,
            model_flops=flops.add(flops.sampling(ctx.config_with_overrides(), batch),
                                  weights=[len(batch_ms)]))
    del gen
    ctx.free_device()
    t0 = time.perf_counter()
    gap = reference_gap(ctx, gcfg, s["weights"], kept)
    ctx.phases["reference_s"] = time.perf_counter() - t0
    n = len(batch_ms)
    return {"attempted": n, "failed": 0, "numbers": {"image_gap": gap}, "peak": peak,
            "end_to_end": {"sample_seqs_per_s": n * batch / window_s,
                           "sample_batch_ms_p90": float(np.percentile(batch_ms, 90))},
            "readings": readings, "sequences": n * batch, "checked": len(kept)}


def reference_gap(ctx, gcfg, weight_seed: int, kept, tf32: bool = False) -> float:
    """The widest image gap over the kept batches, against the reference
    (in TF32 with ``tf32``: the control)."""
    from gpu_bench.bench import reference_configs
    from gpu_bench.reference.generator import Generator

    dev = ctx.device
    rcfg = reference_configs(ctx.config, **ctx.overrides)[0]
    ref = Generator(rcfg, device=dev)
    make_weights([ref], weight_seed)
    ref.eval()
    rng = torch.Generator(device=dev)
    worst = 0.0
    prior = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            for state, images in kept:
                rng.set_state(state)
                z = torch.randn((images.shape[0], rcfg.latent_dimensions), generator=rng,
                                device=dev)
                worst = max(worst, image_gap(images, ref(z, generator=rng).cpu().numpy()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prior
    return worst
