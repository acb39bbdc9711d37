#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Multi-StyleGAN on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--seed 0] [--profile]

Run from the root of a checkout.  It imports only the port
(``multi_stylegan_torch``) and PyTorch, never JAX or the JAX package, and
exits non-zero without a result when CUDA is unavailable or the port is not
beside it.  Phases, each raising on failure:

1. build    - compile every CUDA source of the port (one nvcc per source,
              started together) and print ptxas' register lines.
2. kernels  - hold K1 and K3 against their plain PyTorch versions on the
              card, in f32 and bf16, at every call-site shape of the
              sampling path at batch 16, with times (the NHWC forms, which
              bf16 and autograd calls take); then the planar forms the
              f32 sampling forward takes, on planar views at every site of
              both sampling configurations (``SAMPLING_CONFIGS``, batch
              16: config F's maps past 2^31 bytes, the C = 3 skips), each
              against the plain version and the NHWC launch's bits, with
              its variant, time and bound; K3 and its adjoint
              (K4) at edge cases aimed at each of upfirdn2d's variants;
              K1-K4 on zero rows (M = 0, N = 0: a data rank's empty share
              of a batch): empty results and no launch.
3. sample   - the sampling CLI (``multi_stylegan_torch.cli.sample``, full
              256x256 generator, 32 samples at batch 16, random weights)
              with the launch counts zeroed just before: PNGs, finiteness,
              34 K1 / 24 K3 launches per forward, all but the mapping's 8
              K1 planar; one sample against the
              port on the CPU; a timed batch-16 forward.
4. train    - the training CLI (``multi_stylegan_torch.cli.train
              --synthetic --epochs 1``: the flagship config, batch 24, 96
              sequences, 4 steps, the epoch's sample grids) with the counts
              zeroed just before; then
              one regularised iteration on fresh random weights (every
              bias, noise weight and NonLocal gamma nonzero): ``main_step``
              with wrong order and cut-mix on, ``r1_update``,
              ``path_length_update``.  Every loss and parameter finite, the
              parameters moved, and each sub-step's K1-K4 launches exactly
              what :func:`expected_launches` works out from the model's
              structure, its dx-only K2 launches what
              :func:`expected_dx_only` does, and the optimizer kernels'
              (counters zeroed just before) two a clipped Adam step and
              one an EMA update.  A census of the iteration's
              launches by call site feeds phase 5.  The same iteration runs
              once more under torch.profiler for its top device ops; then
              R1's and path length's gradients of one state with TF32 off
              and on (their times, and TF32's distance from f32).
   4b. bf16_iteration - the same iteration with both models in bf16 (after
              one warm-up main step): exact launches, the D, cut-mix and G
              steps' K1 / K3 sites in bf16 and R1's and path length's in
              f32; its trained state saved for phase 8.  bf16_parity: its
              D-step gradient at batch 1 against the CPU's bf16 plain path,
              max |card - cpu bf16| <= max(4 max |cpu bf16 - cpu f32|,
              2^-8 peak).
   4c. optim - the optimizer kernels (ops/fused_optim.py) over G's and D's
              leaves at the paper's widths, each against the plain per-leaf
              loop on the card from the same state and gradients: a step
              below the clip the same bits, then one with every 4-d
              gradient channels-last (the update gathers it, as it gets
              cuDNN's) the same bits, then a clipped step within rtol 1e-6
              (and 1e-6 of the leaves' peak); G's EMA update against its
              plain loop.  Two launches a step, one an EMA; each one's time,
              the plain loop's and the bytes bound (32 B a value an Adam
              step, 12 an EMA update).
5. grads    - at every K1 / K3 call site the iterations launched (batch 24,
              12 and 6): K1 and K3 forward, K2 (dx and db; and the dx-only
              form with an f32 addend, the double backward's) and K4
              (backward and double backward) against the plain versions on
              the card, in f32 and bf16; kernel, plain and library times and
              the bound in f32, kernel times and the bound in bf16.  K2's
              bias sum must be the same bits in two launches at the largest
              site.  Every K3/K4 site but the C = 3 skip upsamples must take
              a tiled upfirdn2d variant, in both dtypes.  Then K2 in bf16 at
              M * C just over 2^31 (its last rows and its bias sum).
6. parity   - GPU vs CPU (plain versions, TF32 off): a D-step gradient, the
              R1 penalty's parameter gradient and the path-length gradient
              at full width, batch 2, same weights and draws.
   6b. sequential_fft - one main step with ADA's sequential warps at p =
              0.5 and the fft discriminator (f32): finite, moved, exact
              launches; its D-step gradient at batch 2 against the CPU's.
   6c. pl_chunked - the Trainer's path-length ladder (train/robust.py) at
              batch 24: its grads stage unchunked, and demoted to 4 chunks
              by out-of-memory errors injected at 1 and 2 chunks, from one
              state and one set of draws: equal within 1e-4 of the peak;
              times and peak memory of each.  Then the ladder's whole update
              at 4 chunks, as the Trainer calls it: its metrics, moved G
              parameters and 4 times the unchunked update's launches.
7. train_run - the training CLI's whole run at the flagship config: a TLFM
              tree of 16-bit TIFFs written here (48 sequences), trap weights,
              1 epoch (2 steps; trap weights and wrong order from its start,
              moved from 0.25 and 0.75 of the run), the sample grids and a
              checkpoint at its end, FID / FVD / IS once at the end (48
              samples, random-weight nets read from files through
              ``MSG_TPU_INCEPTION_PT`` / ``MSG_TPU_I3D_PT``), a
              torch.profiler trace of step 2 (the run's last).  The CLI's
              resume is phase 11's (every rank's restored state the
              checkpoint's bits); a schedule's switch inside a run only the
              CPU tests hold.  Fails on a non-finite loss or score, a failed
              save, a missing PNG / metric file, a batch-15 grid site on
              upfirdn2d's general form (C = 3 aside), or two grid samples
              off the CPU's by more than ``SAMPLE_TOL``.  Each host Frechet
              distance of the validation is also taken on the card
              (``eval/frechet.py::frechet_distance_device``, Newton-Schulz):
              both values, both times and their gap (``frechet`` line), and
              the device one's time on full-rank activations of 5000 x 2048.
8. reference - phase 4b's checkpoint through ``cli.export`` into the
              reference's 6-key ``.pt`` and back through ``cli.convert``,
              bitwise the source for all the format carries; the training
              CLI from the ``.pt`` (batch 16; its Adam counts go on) and the sampling
              CLI on the models directory it writes.
9. interpolate - ``cli.interpolate`` from that ``.pt``: 96 frames at batch
              32, the GIF's frame count and size, finite frames, the
              launches of three forwards, the upfirdn2d variant of each
              batch-32 site, and two rows of the CLI's own first batch
              against the CPU's images of the latents the CLI fed them.
10. ddp     - two ranks (spawned, gloo: they share the one card) run phase 4's
              f32 iteration at global batch 8, 4 rows each, from its
              seed-made state, draws and batch, the path length through the
              Trainer's ladder; held against the same iteration in one
              process (run first and freed): every update's summed gradient
              within ``GRAD_TOL`` of its peak, the metrics within 1e-3
              relative, the ranks' states the same bits, each rank's K1-K4
              launches the one-process iteration's.  Per rank: launches,
              peak memory, the ladder's tier, each sub-step's seconds and
              its all-reduces' seconds.
10b. tp     - the same check for a (data 1, model 2) mesh of two ranks
              sharing the card (gloo): every sharded conv weight's output
              channels split between them (parallel/tensor.py), the f32
              iteration at the published widths and global batch 4 (every
              channel gather goes through host memory under gloo), held
              against one process at batch 4: the gathered gradients, the
              metrics, what each rank holds whole bitwise across the ranks,
              each rank's launches the one-process iteration's.
10c. ddp_uneven - four data ranks sharing the card (gloo) at the published
              widths, f32, global batch 12: 3 training rows a rank, the
              wrong-order rows [1, 1, 1, 0] and the path-length rows
              [2, 2, 1, 1] (batch 24 over 8 ranks at half the ranks); the
              same checks against one process at batch 12, each rank's
              launches the one-process iteration's but rank 3's D step,
              which launches what it would without wrong order.
11. ddp_cli - ``cli.train --devices 2`` at the tiny config (two ranks on the
              card): 2 epochs with a checkpoint each, then a resume of the
              first for 1 epoch on 2 ranks; one writer, the resume bitwise
              the uninterrupted run, every kernel launched on every rank.
12. teacher - ``tools/stability_run.py``: the teacher fixture, flagship
              config, bf16, batch 8 (cut from 16 for the soak phase's time), 17
              steps through ``Trainer.train``
              (the lazy R1 and path length at step 16), a checkpoint at
              step 8 restored into other weights; every metric finite.
13. soak    - ``tools/soak_b24.py`` at the flagship config, bf16, batch 24,
              the teacher fixture, 2 epochs of 8 steps: phase A (8 steps, a
              checkpoint at epoch 1, FID / FVD / IS at 48 samples), then
              phase B in this process restored at step 8 under
              ``resume_training`` to step 16 (R1 and path length at step
              16), its validation pass left to the tool's long run; ``ok``,
              the steps, phase A's FID / FVD / IS run and none failed, every
              kernel (and the dx-only K2) launched in phase B.

Prints one ``site`` line per call site (K3/K4 lines name the ``variant``
of upfirdn2d the launch took; K2 has a line per form; phase 2's planar
sites have ``"layout": "planar"``), one ``edge`` line
per upfirdn2d edge case and one for K2's,
one ``train_run`` line (loader, step, grid, checkpoint and metric seconds,
checkpoint MB, peak memory, the top 15 device ops), one line for each phase
from 4b on, a ``seconds`` line, the card's name and power limit,
one ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.
In the kernels line ``launches`` sums the main-path runs (sampling CLI,
training CLI, the f32 and bf16 iterations, the sequential + fft main step,
the path-length ladder's update, the training run, the
training and sampling CLIs of phase 8, the interpolation CLI, every rank of
phases 10, 10b and 10c, every rank of phase 11's two runs, the teacher run, both
soak phases), each counted
from zero, and ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are
per f32 regularised training iteration at batch 24: each training call
site's time per launch times its launches in that iteration, summed.  The ``bf16 iteration kernels`` line does the
same for the bf16 iteration.  The optimizer kernels' entries (``clipped_adam``,
``ema_update``) count the launches of the f32 and bf16 iterations, and
their times are phase 4c's per step times the iteration's steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the f32
# rate outside the tensor cores, which is what these elementwise and
# stencil kernels use.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

BATCH = 16
SAMPLES = 32
# The benchmark's f32 sampling configurations, whose forwards run planar.
SAMPLING_CONFIGS = {"msg256": "gpu_bench/configs/msg256-f32.json",
                    "sg2f1024": "gpu_bench/configs/sg2f-ffhq1024-f32.json"}
# f32: both sides sum the same f32 products in different orders; 1e-5 of the
# output's peak is ~100 ulps.  bf16: both round one f32 value to bf16, and
# an order difference may flip that rounding by one bf16 ulp (2^-8 relative).
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TRAIN_BATCH = 24
# Training gradients GPU vs CPU: f32 both sides, TF32 off; the two sides
# pick other conv algorithms and sum orders through G's and D's double
# backward.  1e-3 of the gradient's peak; a wiring fault is O(1).
GRAD_TOL = 1e-3
# Whole-sample GPU-vs-CPU parity: f32 on both, TF32 off; cuDNN and the CPU
# library pick different convolution algorithms (Winograd or FFT among them)
# and summation orders over 14 conv layers and the mapping.  1e-3 of the
# image's peak leaves margin over that while any structural fault (a wrong
# pad, tap flip or wiring) is O(1).
SAMPLE_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def cuda_ms(fn, min_total_ms: float = 30.0, min_iters: int = 3) -> float:
    """Mean device time of ``fn`` in ms over a run of launches (CUDA events):
    at least ``min_iters`` after a warm-up and a first timed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(50, max(min_iters, min_total_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, ref) -> float:
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(ref.shape)} {ref.dtype}")
    return float((got.detach().float() - ref.detach().float()).abs().max())


def check(name: str, got, ref, dtype_name: str) -> float:
    import torch

    torch.cuda.synchronize()
    err = max_err(got, ref)
    peak = float(ref.detach().float().abs().max())
    limit = TOL[dtype_name] * max(1.0, peak)
    if not math.isfinite(err) or err > limit:
        raise AssertionError(f"{name} [{dtype_name}]: max abs err {err} > {limit}")
    return err


# ------------------------------------------------------------------ kernels


def upfirdn_taps_used(n_in: int, n_out: int, up: int, down: int, pad0: int, k: int) -> int:
    """Sum over output positions of the taps that land on a real input sample."""
    used = 0
    for o in range(n_out):
        u0 = o * down - pad0
        used += sum(1 for t in range(k) if (u0 + t) >= 0 and (u0 + t) % up == 0
                    and (u0 + t) // up < n_in)
    return used


def flr_sites():
    """(label, shape, launches per forward) of every K1 call site at batch 16."""
    sites = [("mapping", (BATCH, 512), 8), ("act r=4", (BATCH, 4, 4, 512), 2)]
    sites += [(f"act r={r}", (BATCH, r, r, 512), 4) for r in (8, 16, 32, 64, 128, 256)]
    return sites


def upfirdn_sites():
    """(label, shape, up, down, pad, gain, launches per forward) of the K3 sites."""
    sites = [(f"blur r={r}", (BATCH, r, r, 512), 1, 1, (2, 1), 4.0, 2)
             for r in (8, 16, 32, 64, 128, 256)]
    sites += [(f"skip-up r={r}", (BATCH, r // 2, r // 2, 3), 2, 1, (2, 1), 1.0, 2)
              for r in (8, 16, 32, 64, 128, 256)]
    return sites


def sampling_sites(cfg, batch: int) -> dict:
    """{site: launches} of K1 and K3 in one f32 forward without autograd of
    the generator ``cfg`` at ``batch``, found on the ``meta`` device (no
    device memory): ("K1", shape) for the 4-D launches and ("K3", shape,
    up, down, normalized pad), shapes in (B, H, W, C) order."""
    import collections

    import torch

    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod

    g = Generator(cfg, device="meta")
    sites = collections.Counter()
    f1, f3 = fused_act._forward, up_mod._upfirdn

    def k1(x, bias, negative_slope, scale):
        if x.dim() == 4:
            sites[("K1", tuple(x.shape))] += 1
        return fused_act.fused_leaky_relu_ref(x, bias, negative_slope, scale)

    def k3(x, kernel, up, down, pad, adjoint=False):
        sites[("K3", tuple(x.shape), up, down, tuple(pad))] += 1
        return up_mod.upfirdn2d_ref(x, kernel, up, down, (pad[2], pad[3], pad[0], pad[1]))

    fused_act._forward, up_mod._upfirdn = k1, k3
    try:
        z = torch.zeros((batch, cfg.latent_dimensions), device="meta")
        noise = [torch.zeros((batch, 1, h, w), device="meta") for h, w in g._noise_shapes()]
        with torch.no_grad():
            g(z, noise=noise)
    finally:
        fused_act._forward, up_mod._upfirdn = f1, f3
    return dict(sites)


def site_taps(cfg, up: int, device):
    """The taps a K3 sampling site runs: the blur after an up-conv (gain 4)
    or the skip upsample (the config's gain)."""
    from multi_stylegan_torch.ops.blur import make_blur_kernel

    return make_blur_kernel(cfg.blur_taps, 4.0 if up == 1 else cfg.skip_upsample_gain,
                            device=device)


def planar(t):
    """An NCHW-contiguous copy of a (B, H, W, C)-ordered tensor, as its
    (B, H, W, C)-ordered view: what the generator's planar forward sends."""
    return t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def upfirdn_edge_cases():
    """Edge cases as (shape, up, down, pad as upfirdn2d takes it, k,
    misaligned): the Pallas kernel's test shapes at C=128 and 256; general
    up/down/pads the models do not use; then cases aimed at each tiled
    variant's edges: odd maps with pad (2, 2), H != W, asymmetric adjoint
    pads (4-tuples are (x0, x1, y0, y1)), widths ragged against the 16-wide
    tiles, crops, C = 8, 24 and 130 (not a multiple of the vector: general),
    a storage offset that misaligns the tensors (general), and up 2 and
    down 2 at C = 256 with B > 1."""
    cases = [((2, h, w, 128), 1, 1, pad, k, False) for pad, k, h, w in [
        ((2, 2), 4, 16, 16), ((2, 1), 4, 17, 16), ((1, 1), 3, 32, 16),
        ((2, 1), 4, 8, 8), ((3, 3), 4, 16, 8), ((3, 3), 4, 31, 16),
        ((3, 3), 4, 33, 16), ((0, 0), 4, 16, 16)]]
    cases += [((1, 16, 16, 256), 1, 1, (2, 1), 4, False),
              ((2, 9, 11, 3), 2, 1, (3, 1), 4, False), ((2, 9, 11, 3), 1, 2, (1, 1), 4, False),
              ((2, 9, 11, 5), 1, 1, (-1, 2), 4, False),
              ((2, 9, 11, 7), 2, 2, (1, 2, 0, 3), 3, False),
              ((2, 8, 8, 130), 2, 1, (2, 1), 4, False)]
    cases += [((2, n, n, c), 1, 1, (2, 2), 4, False)
              for n, c in ((127, 128), (63, 256), (31, 384), (15, 768))]
    cases += [((2, 20, 37, 64), 1, 1, (2, 1), 4, False),
              ((2, 33, 17, 512), 1, 1, (1, 2), 4, False),
              ((2, 17, 33, 8), 1, 1, (0, 3, 1, 2), 4, False),
              ((2, 9, 23, 24), 1, 1, (3, 0, -1, 2), 4, False),
              ((3, 21, 45, 24), 2, 1, (2, 1), 4, False),
              ((2, 9, 13, 24), 2, 1, (2, 1, 1, 2), 4, False),
              ((2, 33, 19, 8), 1, 2, (2, 1, 0, 2), 4, False),
              ((2, 16, 16, 130), 1, 1, (2, 1), 4, False),
              ((2, 16, 16, 64), 1, 1, (2, 1), 4, True),
              ((2, 16, 16, 256), 2, 1, (2, 1), 4, True),
              ((4, 32, 32, 256), 2, 1, (2, 1), 4, False),
              ((4, 64, 64, 256), 1, 2, (1, 1), 4, False)]
    return cases


def misaligned_copy(t):
    """A contiguous copy of ``t`` one element into its storage, so that its
    data pointer is not 16-byte aligned."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def library_upfirdn(x_nhwc, taps, up, pad):
    """One PyTorch call computing the model's upfirdn2d sites (yardstick only):
    a depthwise conv on the pre-padded input for up=1, a depthwise transposed
    conv for up=2.  Returns a callable, or None where no single call fits."""
    import torch
    import torch.nn.functional as F

    c = x_nhwc.shape[-1]
    kh, kw = taps.shape
    x = x_nhwc.permute(0, 3, 1, 2)
    if up == 1:
        xp = F.pad(x, (pad[0], pad[1], pad[0], pad[1])).contiguous(
            memory_format=torch.channels_last)
        w = taps.flip(0, 1)[None, None].expand(c, 1, kh, kw).contiguous()
        return lambda: F.conv2d(xp, w, groups=c)
    p = kh - 1 - pad[0]
    h = x.shape[2]
    op = (h * up + pad[0] + pad[1] - kh + 1) - ((h - 1) * up - 2 * p + kh)
    if p < 0 or not 0 <= op < up:
        return None
    w = taps[None, None].expand(c, 1, kh, kw).contiguous()
    return lambda: F.conv_transpose2d(x, w, stride=up, padding=p, output_padding=op, groups=c)


def phase_kernels(seed: int):
    import torch

    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod
    from multi_stylegan_torch.ops.blur import make_blur_kernel

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    report = {"fused_leaky_relu": [], "upfirdn2d": []}

    # K1: fused bias + leaky-ReLU (Triton)
    for label, shape, per_fwd in flr_sites():
        row = {"site": label, "shape": list(shape), "launches_per_forward": per_fwd}
        c = shape[-1]
        bias = torch.randn(c, generator=g, device=dev)
        for name, dt in dtypes.items():
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            row[f"max_abs_err_{name}"] = check(
                f"fused_leaky_relu {label}",
                fused_act.fused_leaky_relu(x, bias, 0.2, 1.0),
                fused_act.fused_leaky_relu_ref(x, bias, 0.2, 1.0), name)
            if name == "float32":
                m = x.numel() // c
                row["ms"] = cuda_ms(lambda: fused_act.fused_leaky_relu(x, bias, 0.2, 1.0))
                row["plain_ms"] = cuda_ms(lambda: fused_act.fused_leaky_relu_ref(x, bias, 0.2, 1.0))
                row["library_ms"] = None
                row["bound_ms"], row["bound_by"] = bound_ms(2 * m * c * 4 + c * 4, 4 * m * c)
            del x
        report["fused_leaky_relu"].append(row)
        print("site", json.dumps({"kernel": "fused_leaky_relu", **row}), flush=True)

    # K3: upfirdn2d (CUDA C++), model call sites
    for label, shape, up, down, pad, gain, per_fwd in upfirdn_sites():
        row = {"site": label, "shape": list(shape), "up": up, "pad": list(pad),
               "launches_per_forward": per_fwd}
        taps = make_blur_kernel((1, 3, 3, 1), gain, device=dev)
        for name, dt in dtypes.items():
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            got = up_mod.upfirdn2d(x, taps, up, down, pad)
            row[f"max_abs_err_{name}"] = check(
                f"upfirdn2d {label}", got, up_mod.upfirdn2d_ref(x, taps, up, down, pad), name)
            if name == "float32":
                row["variant"] = up_mod.last_variant
                b, h, w, c = shape
                ho, wo = got.shape[1], got.shape[2]
                used = (upfirdn_taps_used(h, ho, up, down, pad[0], 4)
                        * upfirdn_taps_used(w, wo, up, down, pad[0], 4))
                row["ms"] = cuda_ms(lambda: up_mod.upfirdn2d(x, taps, up, down, pad))
                row["plain_ms"] = cuda_ms(lambda: up_mod.upfirdn2d_ref(x, taps, up, down, pad))
                lib = library_upfirdn(x, taps, up, pad)
                if lib is not None:
                    row["library_max_abs_err"] = max_err(lib().permute(0, 2, 3, 1), got)
                row["library_ms"] = cuda_ms(lib) if lib is not None else None
                row["bound_ms"], row["bound_by"] = bound_ms(
                    (x.numel() + got.numel()) * 4 + taps.numel() * 4, 2 * used * b * c)
            del x, got
        report["upfirdn2d"].append(row)
        print("site", json.dumps({"kernel": "upfirdn2d", **row}), flush=True)

    report["planar"] = planar_site_rows(dev, g)

    # K3 and K4 edge cases: correctness only, forward and the adjoint
    edge_err = {"float32": 0.0, "bfloat16": 0.0}
    for shape, up, down, pad, k, misaligned in upfirdn_edge_cases():
        taps = torch.randn((k, k), generator=g, device=dev)
        npad = up_mod._normalize_pad(pad)
        label = f"upfirdn2d edge {shape} up={up} down={down} pad={pad}"
        row = {"shape": list(shape), "up": up, "down": down, "pad": list(pad), "k": k,
               "misaligned": misaligned}
        for name, dt in dtypes.items():
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            x = misaligned_copy(x) if misaligned else x
            got = up_mod.upfirdn2d(x, taps, up, down, pad)
            variants = [up_mod.last_variant]
            err = check(label, got, up_mod.upfirdn2d_ref(x, taps, up, down, pad), name)
            gy = torch.randn(got.shape, generator=g, device=dev).to(dt)
            gy = misaligned_copy(gy) if misaligned else gy
            gx = up_mod.UpFirDn2dBackward.apply(gy, taps, up, down, npad, shape[1:3],
                                                tuple(got.shape[1:3]))
            variants.append(up_mod.last_variant)
            xr = x.detach().clone().requires_grad_(True)
            (rgx,) = torch.autograd.grad(up_mod.upfirdn2d_ref(xr, taps, up, down, pad), xr, gy)
            err = max(err, check(label + " adjoint", gx, rgx, name))
            if misaligned and set(variants) != {"general"}:
                raise AssertionError(f"{label}: a misaligned tensor took a tiled variant")
            if name == "float32":
                row["variant"], row["variant_adjoint"] = variants
            row[f"max_abs_err_{name}"] = err
            edge_err[name] = max(edge_err[name], err)
        print("edge", json.dumps(row), flush=True)
    print("upfirdn2d edge cases ok", json.dumps(edge_err), flush=True)
    # K1 on a ragged [M, C] (C not a power of two, M not a block multiple)
    x = torch.randn((1000, 130), generator=g, device=dev)
    bias = torch.randn(130, generator=g, device=dev)
    check("fused_leaky_relu ragged", fused_act.fused_leaky_relu(x, bias, 0.2, 2.0 ** 0.5),
          fused_act.fused_leaky_relu_ref(x, bias, 0.2, 2.0 ** 0.5), "float32")
    report["upfirdn2d_edge_max_abs_err"] = edge_err
    report["zero_rows"] = zero_row_checks(dev)
    return report


def planar_site_rows(dev, g) -> list:
    """K1 and K3 on the planar views the f32 sampling forward sends them, at
    every site of each of ``SAMPLING_CONFIGS`` at batch 16: against the
    plain version, and against the NHWC launch on the same values (K1 the
    same bits; K3 the same bits where the NHWC launch takes a tiled form),
    with the variant, ms a launch in both layouts and the bound."""
    import torch

    from multi_stylegan_torch.cli.sample import generator_config
    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod

    rows = []
    for name, path in SAMPLING_CONFIGS.items():
        cfg = generator_config(str(REPO / path))
        for site, n in sorted(sampling_sites(cfg, BATCH).items(), key=str):
            b, h, w, c = site[1]
            x = torch.randn((b, c, h, w), generator=g, device=dev).permute(0, 2, 3, 1)
            nhwc = x.contiguous()
            row = {"config": name, "shape": [b, h, w, c], "launches_per_forward": n}
            label = f"planar {name} {site}"
            if site[0] == "K1":
                kernel = "fused_leaky_relu"
                bias = torch.randn(c, generator=g, device=dev)
                got = fused_act._forward(x, bias, 0.2, 1.0)
                want = fused_act._forward(nhwc, bias, 0.2, 1.0)
                row["max_abs_err_float32"] = check(
                    label, got, fused_act.fused_leaky_relu_ref(x, bias, 0.2, 1.0), "float32")
                if not (fused_act.is_planar(got) and torch.equal(got, want)):
                    raise AssertionError(f"{label}: not the NHWC launch's bits in the planar "
                                         "layout")
                row["ms"] = cuda_ms(lambda: fused_act._forward(x, bias, 0.2, 1.0))
                row["ms_nhwc"] = cuda_ms(lambda: fused_act._forward(nhwc, bias, 0.2, 1.0))
                row["bound_ms"], row["bound_by"] = bound_ms(2 * x.numel() * 4 + c * 4,
                                                            4 * x.numel())
            else:
                kernel = "upfirdn2d"
                _, _, up, down, pad = site
                taps = site_taps(cfg, up, dev)
                row.update(up=up, down=down, pad=list(pad))
                got = up_mod._upfirdn(x, taps, up, down, pad)
                row["variant"] = up_mod.last_variant
                if row["variant"] != f"planar-up{up}-down{down}" or not fused_act.is_planar(got):
                    raise AssertionError(f"{label}: took {row['variant']}")
                row["max_abs_err_float32"] = check(label, got, up_mod.upfirdn2d_ref(
                    x, taps, up, down, (pad[2], pad[3], pad[0], pad[1])), "float32")
                want = up_mod._upfirdn(nhwc, taps, up, down, pad)
                row["variant_nhwc"] = up_mod.last_variant
                row["same_bits_as_nhwc"] = bool(torch.equal(got, want))
                if row["variant_nhwc"] != "general" and not row["same_bits_as_nhwc"]:
                    raise AssertionError(f"{label}: not the NHWC tiled form's bits")
                row["ms"] = cuda_ms(lambda: up_mod._upfirdn(x, taps, up, down, pad))
                row["ms_nhwc"] = cuda_ms(lambda: up_mod._upfirdn(nhwc, taps, up, down, pad))
                used = (upfirdn_taps_used(h, got.shape[1], up, down, pad[0], 4)
                        * upfirdn_taps_used(w, got.shape[2], up, down, pad[2], 4))
                row["bound_ms"], row["bound_by"] = bound_ms(
                    (x.numel() + got.numel()) * 4 + taps.numel() * 4, 2 * used * b * c)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            del x, nhwc, got, want
            rows.append(row)
            print("site", json.dumps({"kernel": kernel, "layout": "planar", **row}), flush=True)
    return rows


def zero_row_checks(dev) -> dict:
    """A data rank's empty share of a batch (phase ddp_uneven's rank 3 in
    its D step on the wrong-order rows) through each kernel's wrapper, in
    f32 and bf16: K1 and K3 at each tiled up/down form on M = 0 / N = 0,
    their gradients (K2 with its bias sum, K4) and gradients of gradients
    (the dx-only K2, K3 again).  Every result empty and of the right shape
    and dtype, K2's bias sum exact zeros, and no kernel launched."""
    import torch

    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod
    from multi_stylegan_torch.ops.blur import make_blur_kernel

    def counts():
        return (*read_counts().values(), fused_act.grad_dx_only_launches)

    before, shapes = counts(), {}
    taps = make_blur_kernel((1, 3, 3, 1), 1.0, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.empty((0, 16, 16, 512), device=dev, dtype=dt, requires_grad=True)
        bias = torch.randn(512, device=dev, requires_grad=True)
        y = fused_act.fused_leaky_relu(x, bias)
        v = torch.randn(y.shape, device=dev, dtype=dt, requires_grad=True)
        gx, gb = torch.autograd.grad((y * v).sum(), [x, bias], create_graph=True)
        (gv,) = torch.autograd.grad(gx.float().square().sum() + gb.square().sum(), v)
        if not (y.shape == gx.shape == gv.shape == x.shape and y.dtype == gx.dtype == dt
                and torch.equal(gb, torch.zeros_like(gb))):
            raise AssertionError(f"K1/K2 on zero rows: {y.shape} {gx.shape} {gv.shape} {gb}")
        shapes["K1/K2 " + str(dt)] = list(y.shape)
        for up, down, pad in ((1, 1, (2, 1)), (2, 1, (2, 1)), (1, 2, (1, 1))):
            y = up_mod.upfirdn2d(x, taps, up, down, pad)
            ho = up_mod.out_size(16, up, down, pad[0], pad[1], 4)
            v = torch.randn(y.shape, device=dev, dtype=dt, requires_grad=True)
            (gx,) = torch.autograd.grad((y * v).sum(), x, create_graph=True)
            (gv,) = torch.autograd.grad(gx.float().square().sum(), v)
            if not (y.shape == (0, ho, ho, 512) and y.dtype == dt and gx.shape == x.shape
                    and gv.shape == y.shape):
                raise AssertionError(f"K3/K4 up {up} down {down} on zero rows: {y.shape}")
            shapes[f"K3/K4 up{up}-down{down} {dt}"] = list(y.shape)
    after = counts()
    if after != before:
        raise AssertionError(f"zero rows launched kernels: {before} -> {after}")
    out = {"shapes": shapes, "launches": [a - b for a, b in zip(after, before)]}
    print("zero_rows", json.dumps(out), flush=True)
    return out


# -------------------------------------------------------------------- slice


def random_generator(config, seed: int):
    """Reference init from ``seed``, then every zero-initialised bias and
    noise weight drawn too, so that each path of the network carries signal."""
    import torch

    from multi_stylegan_torch.models.generator import Generator, NoiseInjection, OutputBlock
    from multi_stylegan_torch.nn.equalized import FusedLeakyReLU

    gen = Generator(config)
    cpu = torch.Generator().manual_seed(seed)
    gen.reset_parameters(cpu)
    with torch.no_grad():
        for module in gen.modules():
            if isinstance(module, (FusedLeakyReLU, NoiseInjection, OutputBlock)):
                for p in module.parameters(recurse=False):
                    p.copy_(0.2 * torch.randn(p.shape, generator=cpu))
    return gen.eval()


def phase_slice(seed: int, report: dict):
    import torch

    from multi_stylegan_torch.cli import sample
    from multi_stylegan_torch.models.config import GeneratorConfig
    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod

    config = GeneratorConfig()
    cpu_gen = random_generator(config, seed)
    forwards = -(-SAMPLES // BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "generator.pt")
        torch.save({"generator_ema": cpu_gen.state_dict()}, ckpt)
        out_dir = os.path.join(tmp, "samples")
        fused_act.launches = fused_act.planar_launches = 0
        up_mod.launches = up_mod.planar_launches = 0
        run = sample.main(["--checkpoint", ckpt, "--samples", str(SAMPLES),
                           "--batch_size", str(BATCH), "--seed", str(seed),
                           "--output", out_dir, "--device", "cuda"])
        torch.cuda.synchronize()
        counts = {"fused_leaky_relu": fused_act.launches, "upfirdn2d": up_mod.launches}
        planar_counts = {"fused_leaky_relu": fused_act.planar_launches,
                         "upfirdn2d": up_mod.planar_launches}
        files = sorted(os.listdir(out_dir))
    expected = sorted(f"sample_{i}_{d}_0.png" for i in range(SAMPLES) for d in ("bf", "gfp"))
    if files != expected:
        raise AssertionError(f"CLI wrote {len(files)} files, expected the {len(expected)} "
                             f"save_prediction names: {files[:4]}...")
    if not run["finite"]:
        raise AssertionError("CLI produced non-finite images")
    want = {"fused_leaky_relu": 34 * forwards, "upfirdn2d": 24 * forwards}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want} ({forwards} forwards)")
    # the f32 forward under inference_mode is planar: every launch but the
    # mapping network's 8 K1 on [B, 512]
    want = {"fused_leaky_relu": 26 * forwards, "upfirdn2d": 24 * forwards}
    if planar_counts != want:
        raise AssertionError(f"planar launches {planar_counts}, expected {want}")
    print("slice cli", json.dumps({**run, "launches": counts, "planar_launches": planar_counts,
                                   "samples_per_s": run["samples"] / run["seconds"],
                                   "generate_samples_per_s":
                                       run["samples"] / run["generate_seconds"]}), flush=True)

    # one sample, same weights and noise: the card's kernels vs the CPU's plain versions
    gpu_gen = random_generator(config, seed).cuda()
    rng = torch.Generator().manual_seed(seed + 1)
    z = torch.randn((1, config.latent_dimensions), generator=rng)
    noise = cpu_gen.random_noise(1, rng)
    with torch.inference_mode():
        ref = cpu_gen(z, noise=noise)
        got = gpu_gen(z.cuda(), noise=[n.cuda() for n in noise]).cpu()
    peak = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not (ref.shape == (1, 2, 3, 256, 256) and math.isfinite(err)
            and err <= SAMPLE_TOL * max(1.0, peak)):
        raise AssertionError(f"GPU vs CPU sample: shape {tuple(got.shape)}, "
                             f"max abs err {err} vs limit {SAMPLE_TOL * max(1.0, peak)}")

    # steady batch-16 forward on the card
    rng = torch.Generator(device="cuda").manual_seed(seed + 2)
    z16 = torch.randn((BATCH, config.latent_dimensions), generator=rng, device="cuda")
    noise16 = gpu_gen.random_noise(BATCH, rng)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: gpu_gen(z16, noise=noise16), min_total_ms=1000.0)
    # the forms this forward runs: the mapping's NHWC K1, the planar rest
    planar_rows = [r for r in report["planar"] if r["config"] == "msg256"]
    kernel_ms = {
        "fused_leaky_relu": sum(r["ms"] * r["launches_per_forward"]
                                for r in report["fused_leaky_relu"] if r["site"] == "mapping")
        + sum(r["ms"] * r["launches_per_forward"] for r in planar_rows if "up" not in r),
        "upfirdn2d": sum(r["ms"] * r["launches_per_forward"] for r in planar_rows if "up" in r)}
    # model FLOPs of the convolutions and matmuls (the two kernels add no
    # multiply-adds of that kind), counted by PyTorch from the shapes
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        gpu_gen(z16, noise=noise16)
    flops = float(counter.get_total_flops())
    slice_row = {"sample_max_abs_err": err, "sample_peak": peak,
                 "forward_ms_b16": fwd_ms, "forward_samples_per_s": BATCH / fwd_ms * 1e3,
                 "model_tflop_per_forward": flops / 1e12,
                 "model_tflops_per_s": flops / fwd_ms / 1e9,
                 "share_of_f32_peak": flops / fwd_ms / 1e9 / (F32_FLOPS_PER_S / 1e12),
                 "kernel_ms_per_forward": kernel_ms,
                 "kernel_share_of_forward": sum(kernel_ms.values()) / fwd_ms,
                 "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("slice", json.dumps(slice_row), flush=True)
    return counts, {**run, **slice_row}, (gpu_gen, z16, noise16)


def phase_profile(gpu_gen, z, noise) -> dict:
    """Device time of one forward by kernel, from torch.profiler (--profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        gpu_gen(z, noise=noise)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gpu_gen(z, noise=noise)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in kernels),
                        key=lambda r: -r[1])

    def category(name: str) -> str:
        low = name.lower()
        if "upfirdn2d" in low:
            return "upfirdn2d (K3)"
        if "flr_fwd" in low:
            return "fused_leaky_relu (K1)"
        if any(k in low for k in ("conv", "xmma", "gemm", "sm90", "cutlass", "implicit",
                                  "winograd", "dgrad", "wgrad", "fft")):
            return "convolution / matmul"
        return "other (elementwise, copies, reductions)"

    totals = {}
    for name, ms, _ in per_kernel:
        totals[category(name)] = totals.get(category(name), 0.0) + ms
    row = {"device_ms": sum(totals.values()), "by_category_ms": totals,
           "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                           for n, ms, c in per_kernel[:12]]}
    print("profile", json.dumps(row), flush=True)
    return row


# ------------------------------------------------------------------- train


# The training phases' device and configs, module settings so that a CPU
# rehearsal (with the kernels' plain versions standing in) can swap them.
DEVICE = "cuda"
CONFIG_ARGS = []  # training CLI flags that pick the config (the flagship: none)


def train_configs(dtype: str = "float32", fft: bool = False):
    """(generator, discriminator) configs of the training phases: the
    flagship, in ``dtype``, the discriminator with its fft branch if asked."""
    from multi_stylegan_torch.models.config import DiscriminatorConfig, GeneratorConfig

    return (GeneratorConfig(compute_dtype=dtype),
            DiscriminatorConfig(no_rfp=True, compute_dtype=dtype, fft=fft))


def train_cli_args(seed: int, experiment: str):
    return ["--synthetic", "--epochs", "1", "--batch_size", str(TRAIN_BATCH),
            "--seed", str(seed), "--device", DEVICE, "--experiment_path", experiment]


def grid_launches(gcfg, epochs: int) -> dict:
    """K1 / K3 launches of the end-of-epoch sample grids: four G forwards a
    epoch (EMA and training G, fixed and random noise), each mapping two
    latents (the grids mix)."""
    s = model_sites(gcfg, None)
    return {"K1": 4 * epochs * s["g_k1"], "K2": 0, "K3": 4 * epochs * s["g_k3"], "K4": 0}


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def zero_counts() -> None:
    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod

    fused_act.launches = fused_act.grad_launches = fused_act.grad_dx_only_launches = 0
    up_mod.launches = up_mod.grad_launches = 0


def read_counts() -> dict:
    import torch

    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod

    sync()
    return {"K1": fused_act.launches, "K2": fused_act.grad_launches,
            "K3": up_mod.launches, "K4": up_mod.grad_launches}


def model_sites(gcfg, dcfg) -> dict:
    """Per-forward kernel sites of the models, from their structure.

    D: every ResNet block holds two K1 (NonLocal blocks, encoder 2 and
    decoder 1, hold none), plus the scalar head's and the pixel head's; one
    K3 per downscale blur and per decoder upsample.  G: ``build_wplus`` maps
    two latents (one K1 per mapping layer each), one K1 per styled conv; one
    K3 per post-upsample blur and per skip upsample, in both towers.  With
    remat every block (all blocks: remat_min_px 0) is recomputed once per
    backward pass that reaches it."""
    if gcfg.remat_min_px or (dcfg is not None and dcfg.remat_min_px):
        raise ValueError("the launch formula assumes remat_min_px = 0 (every block)")
    n = gcfg.n_stages
    styled = 2 * (1 + 2 * n)
    d_sites = {}
    if dcfg is not None:
        enc, dec = dcfg.encoder_channels, dcfg.decoder_channels
        n_res = (len(enc) - 1) + (len(dec) - 1)
        d_sites = dict(d_k1=2 * n_res + 2, d_k3=(len(enc) - 1) + len(dec),
                       d_remat_k1=2 * n_res if dcfg.remat else 0)
    return dict(
        **d_sites,
        g_k1=2 * gcfg.depth_style_mapping + styled, g_styled=styled,
        g_k3=4 * n, g_blur=2 * n,
        g_remat_k1=styled if gcfg.remat else 0, g_remat_k3=4 * n if gcfg.remat else 0)


def expected_launches(gcfg, dcfg, sub_step: str, wrong_order: bool = False) -> dict:
    """K1-K4 launches of one sub-step, worked out from ``model_sites``.

    * d_step: G samples the fakes without grad; D runs on reals, fakes (and
      wrong-order reals): each D pass is forward, remat recompute and one K2
      per K1 site / one K4 per K3 site in the backward.
    * cut_mix: two D passes on the pixel head only, so the scalar head's
      activation gets no K2.
    * g_step: G and D forward, both recomputed, K2/K4 at every site.
    * r1: D forward; the create_graph backward (recompute + K2/K4); the
      parameter backward runs each K2 and K4 Function's own backward (one
      more K2 / K4) and the forward's backward again (another), and
      recomputes the blocks once more.
    * path_length: G forward; the backward to w+ gives K2 at the styled
      convs (not the mapping) and K4 at every K3; the parameter backward
      gives K2 again at the styled convs plus at every G K1 site, K4 at the
      blurs twice (the K4 double backward and the forward's backward), none
      at the skip upsamples (the image is linear in them, so w+'s gradient
      does not depend on them); two block recomputes.

    R1 and path length run the f32 variants, which always rematerialize
    (train/steps.py ``F32``), whatever the configs say.
    """
    s = model_sites(gcfg, dcfg)
    dk1, dk3, rd = s["d_k1"], s["d_k3"], s["d_remat_k1"]
    gk1, gk3, rg1, rg3 = s["g_k1"], s["g_k3"], s["g_remat_k1"], s["g_remat_k3"]
    s32 = model_sites(dataclasses.replace(gcfg, remat=True), dataclasses.replace(dcfg, remat=True))
    rd32, rg1_32, rg3_32 = s32["d_remat_k1"], s32["g_remat_k1"], s32["g_remat_k3"]
    nd = 3 if wrong_order else 2
    table = {
        "d_step": dict(K1=gk1 + nd * (dk1 + rd), K2=nd * dk1, K3=gk3 + nd * dk3, K4=nd * dk3),
        "cut_mix_step": dict(K1=2 * (dk1 + rd), K2=2 * (dk1 - 1), K3=2 * dk3, K4=2 * dk3),
        "g_step": dict(K1=gk1 + rg1 + dk1 + rd, K2=gk1 + dk1, K3=gk3 + rg3 + dk3, K4=gk3 + dk3),
        "r1_update": dict(K1=dk1 + 2 * rd32, K2=3 * dk1, K3=dk3, K4=3 * dk3),
        "path_length_update": dict(K1=gk1 + 2 * rg1_32, K2=2 * s["g_styled"] + gk1,
                                   K3=gk3 + 2 * rg3_32, K4=gk3 + 2 * s["g_blur"]),
    }
    return table[sub_step]


def expected_dx_only(gcfg, dcfg, sub_step: str) -> int:
    """K2 launches of the dx-only form (``FusedLeakyReLUDoubleBackward``) in
    one sub-step: the double backward at every D K1 site in R1 and at the
    styled convs in path length (the mapping's K2 runs once, not twice);
    none in the first-order sub-steps."""
    s = model_sites(gcfg, dcfg)
    return {"r1_update": s["d_k1"], "path_length_update": s["g_styled"]}.get(sub_step, 0)


def random_discriminator(config, seed: int):
    """Reference init from ``seed``, then every bias and NonLocal gamma drawn
    nonzero (gamma starts at 0, which would hide the attention path)."""
    import torch

    from multi_stylegan_torch.models.discriminator import Discriminator

    disc = Discriminator(config)
    cpu = torch.Generator().manual_seed(seed)
    disc.reset_parameters(cpu)
    with torch.no_grad():
        for name, p in disc.named_parameters():
            if not name.endswith("weight"):
                p.copy_(0.2 * torch.randn(p.shape, generator=cpu) + 0.1)
    return disc


def real_batch(batch: int, resolution, seed: int):
    import numpy as np
    import torch

    from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset

    data = SyntheticTLFMDataset(n_samples=batch, resolution=resolution, seed=seed)
    return torch.from_numpy(np.stack([data[i] for i in range(batch)]))


class Census:
    """Counts launches per call site by wrapping the kernels' launch
    functions (the wrappers' own counters are untouched)."""

    def __init__(self):
        from collections import Counter

        from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod

        self.sites = Counter()
        self._mods = (fused_act, up_mod)
        self._orig = (fused_act._fused_leaky_relu_cuda, fused_act._fused_leaky_relu_grad_cuda,
                      up_mod._upfirdn2d_cuda)

    def __enter__(self):
        fa, um = self._mods
        f1, f2, f3 = self._orig

        def k1(x, *a):
            self.sites[("K1", tuple(x.shape), str(x.dtype))] += 1
            return f1(x, *a)

        def k2(g, out, slope, scale, addend=None, need_db=True):
            form = () if need_db else ("dx only",)
            self.sites[("K2", tuple(g.shape), str(g.dtype)) + form] += 1
            return f2(g, out, slope, scale, addend, need_db)

        def k3(x, kernel, up, down, pad, adjoint=False):
            kind = "K4" if adjoint else "K3"
            self.sites[(kind, tuple(x.shape), str(x.dtype), up, down, tuple(pad),
                        tuple(kernel.shape))] += 1
            return f3(x, kernel, up, down, pad, adjoint)

        fa._fused_leaky_relu_cuda, fa._fused_leaky_relu_grad_cuda, um._upfirdn2d_cuda = k1, k2, k3
        return self

    def __exit__(self, *exc):
        fa, um = self._mods
        fa._fused_leaky_relu_cuda, fa._fused_leaky_relu_grad_cuda, um._upfirdn2d_cuda = self._orig


def empty_cache() -> None:
    import gc

    import torch

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def all_finite(module) -> bool:
    import torch

    return all(bool(torch.isfinite(p).all()) for p in module.parameters())


def phase_train_cli(seed: int):
    import torch

    from multi_stylegan_torch.cli import train

    with tempfile.TemporaryDirectory() as tmp:
        zero_counts()
        run = train.main(train_cli_args(seed, os.path.join(tmp, "experiment")))
        counts = read_counts()
    steps = run["steps"]
    gcfg, dcfg = train_configs()
    # one epoch of one: no wrong order, cut-mix probability 0, no lazy step;
    # then the epoch's sample grids
    per_step = {k: expected_launches(gcfg, dcfg, "d_step")[k]
                + expected_launches(gcfg, dcfg, "g_step")[k] for k in counts}
    want = {k: v * steps + grid_launches(gcfg, 1)[k] for k, v in per_step.items()}
    state = run["state"]
    if steps != 4 or not run["finite"] or not all_finite(state.generator) \
            or not all_finite(state.discriminator):
        raise AssertionError(f"training CLI: {steps} steps, finite={run['finite']}")
    if counts != want:
        raise AssertionError(f"training CLI launches {counts}, expected {want}")
    hist = run["history"]
    row = {"steps": steps, "seconds": run["seconds"], "launches": counts,
           "step_seconds": [m["seconds"] for m in hist],
           "last_losses": {k: v for k, v in hist[-1].items() if k.startswith("loss")},
           "sequences_per_s_steady": TRAIN_BATCH * (steps - 1) / sum(m["seconds"] for m in hist[1:])}
    print("slice train cli", json.dumps(row), flush=True)
    del run, state
    empty_cache()
    return counts, row


def phase_train_iteration(seed: int, dtype: str = "float32", save_to: str = ""):
    """One regularised iteration at the flagship config, batch 24, in
    ``dtype``; R1 and path length run their f32 variants whatever it is.
    With ``save_to`` the trained state is written there as the trainer's
    checkpoint (for phase ``reference``)."""
    import torch

    from multi_stylegan_torch.io.checkpoint import CheckpointManager, train_state_dict
    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.ops import fused_act, fused_optim
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import StepFlags, TrainStep

    (gcfg, dcfg), cfg = train_configs(dtype), TrainingConfig()
    gen = random_generator(gcfg, seed + 10).train().to(DEVICE)
    disc = random_discriminator(dcfg, seed + 11).to(DEVICE)
    state = create_train_state(gen, disc, cfg)
    ts = TrainStep(cfg, top_k_start_iteration=0, top_k_final_iteration=2)
    draws = TorchDraws(torch.Generator(device=DEVICE).manual_seed(seed + 12))
    real = real_batch(TRAIN_BATCH, gcfg.resolution, seed + 13).to(DEVICE)
    before = {n: p.detach().clone() for n, p in
              list(gen.named_parameters(prefix="g")) + list(disc.named_parameters(prefix="d"))}
    ema_before = [p.clone() for p in state.g_ema.parameters()]

    timings, per_sub, dx_only, dtypes = {}, {}, {}, {}

    def timed(name, fn):
        def run(*a, **kw):
            sync()
            c0, d0, t0 = read_counts(), fused_act.grad_dx_only_launches, time.perf_counter()
            with Census() as sub:
                out = fn(*a, **kw)
            c1 = read_counts()  # synchronizes
            timings[name] = (time.perf_counter() - t0) * 1e3
            per_sub[name] = {k: c1[k] - c0[k] for k in c1}
            dx_only[name] = fused_act.grad_dx_only_launches - d0
            # the dtypes the sub-step's K1 / K3 sites ran in (4-d: the spatial ones)
            dtypes[name] = sorted({k[2] for k in sub.sites if len(k[1]) == 4})
            return out
        return run

    for name in ("d_step", "cut_mix_step", "g_step"):
        setattr(ts, name, timed(name, getattr(ts, name)))
    adam_steps = count_adam_steps(state)
    flags = StepFlags(wrong_order=True, do_cut_mix=True, do_ema=False)
    if dtype != "float32":
        # the first bf16 step compiles Triton's bf16 K1 / K2 and lets cuDNN
        # pick its bf16 algorithms (the f32 ones were warmed by phase 4's CLI)
        ts.main_step(state, real, flags, draws)
        sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    fused_optim.adam_launches = fused_optim.ema_launches = 0
    adam_steps[0] = 0
    with Census() as census:
        metrics = timed("main_step", ts.main_step)(state, real, flags, draws)
        r1 = timed("r1_update", ts.r1_update)(state, real)
        pen, pl = timed("path_length_update", ts.path_length_update)(state, draws)
    counts = read_counts()
    optim = {"adam_steps": adam_steps[0], "adam_launches": fused_optim.adam_launches,
             "ema_launches": fused_optim.ema_launches}
    peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else None
    metrics.update(loss_discriminator_regularization=r1, loss_path_length_regularization=pen,
                   path_length=pl)
    host = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in host.items() if not math.isfinite(v)]
    if bad or not all_finite(gen) or not all_finite(disc) or not all_finite(state.g_ema):
        raise AssertionError(f"regularised iteration [{dtype}]: non-finite {bad or 'parameters'}")
    after = dict(list(gen.named_parameters(prefix="g")) + list(disc.named_parameters(prefix="d")))
    unmoved = [n for n, p in after.items() if torch.equal(p.detach(), before[n])]
    # a G parameter the path-length step leaves alone may sit still only if
    # the G step moved it; every D parameter moves in the D steps
    if unmoved:
        raise AssertionError(f"[{dtype}] parameters did not move: {unmoved[:8]}")
    if all(torch.equal(a, b) for a, b in zip(ema_before, state.g_ema.parameters())):
        raise AssertionError(f"[{dtype}] the EMA did not move")
    # the optimizers: D once in the D step, twice in cut-mix and once in R1,
    # G once in the G step and once in path length, which runs the one EMA
    steps = sum(ITERATION_ADAM_STEPS.values())
    want = {"adam_steps": steps, "adam_launches": 2 * steps,
            "ema_launches": ITERATION_EMA_UPDATES}
    if DEVICE == "cpu":  # a rehearsal: the plain loops launch nothing
        want.update(adam_launches=0, ema_launches=0)
    if optim != want:
        raise AssertionError(f"[{dtype}] optimizer launches {optim}, expected {want}")
    for name in ("d_step", "cut_mix_step", "g_step", "r1_update", "path_length_update"):
        want = expected_launches(gcfg, dcfg, name, wrong_order=(name == "d_step"))
        if per_sub[name] != want:
            raise AssertionError(f"[{dtype}] {name}: launches {per_sub[name]}, expected {want}")
        if dx_only[name] != expected_dx_only(gcfg, dcfg, name):
            raise AssertionError(f"[{dtype}] {name}: {dx_only[name]} dx-only K2 launches, "
                                 f"expected {expected_dx_only(gcfg, dcfg, name)}")
    # the D, cut-mix and G steps run in the configs' dtype, R1 and path length in f32
    step_dtype = str(getattr(torch, dtype))
    for name in ("d_step", "cut_mix_step", "g_step", "r1_update", "path_length_update"):
        want = ["torch.float32"] if name in ("r1_update", "path_length_update") else [step_dtype]
        if dtypes[name] != want:
            raise AssertionError(f"[{dtype}] {name} ran its K1 / K3 sites in {dtypes[name]}")
    # the same iteration once more under torch.profiler (the trainer's
    # profiling utility), apart from the timed one above; its sub-steps'
    # times are kept apart from the first run's
    from multi_stylegan_torch.utils.profiling import trace

    first_ms, timings = timings, {}
    with tempfile.TemporaryDirectory() as tmp, trace(tmp) as tr:
        ts.main_step(state, real, flags, draws)
        ts.r1_update(state, real)
        ts.path_length_update(state, draws)
        sync()
    if save_to:
        CheckpointManager(save_to).save(state.step, {"train_state": train_state_dict(state)})
    tf32 = tf32_regularisers(ts, state, real, draws) if dtype == "float32" else None
    row = {"dtype": dtype, "ms": first_ms, "ms_under_profiler": timings,
           "launches": counts, "optimizer_launches": optim, "launches_by_sub_step": per_sub,
           "k2_dx_only_launches_by_sub_step": dx_only,
           "site_dtypes_by_sub_step": dtypes, "peak_memory_gib": peak, "metrics": host,
           "ada_p": float(state.ada.p), "top_device_ops": top_device_ops(tr.prof), "tf32": tf32}
    print("slice train", json.dumps(row), flush=True)
    del state, gen, disc
    empty_cache()
    return counts, census.sites, row


# The optimizer updates of one regularised iteration (phase 4's): Adam
# steps of D (D step, cut-mix's two, R1) and G (G step, path length); EMA
# updates (path length's; the main step's is off, as on the trainer's
# path-length steps).
ITERATION_ADAM_STEPS = {"D": 4, "G": 2}
ITERATION_EMA_UPDATES = 1
ADAM_BYTES, EMA_BYTES = 32, 12  # a value's: g read twice, p, m, v read and written; e, p, e


def count_adam_steps(state) -> list:
    """Count both optimizers' steps into the returned one-element list."""
    calls = [0]
    for opt in (state.d_opt, state.g_opt):
        def counted(grads, _step=opt.step):
            calls[0] += 1
            return _step(grads)
        opt.step = counted
    return calls


def adam_tensors(opt) -> dict:
    """``opt``'s tensors and scalars, as ops/fused_optim.py's steps take them."""
    return dict(params=opt.params, exp_avg=opt.exp_avg, exp_avg_sq=opt.exp_avg_sq,
                count=opt.count, notfinite_count=opt.notfinite_count,
                lrs=[lr for ps, lr in opt.groups for _ in ps],
                sharded=[d is not None for d in opt.shard_dims], hyper=opt.hyper())


def optim_gap(fused, plain) -> tuple:
    """The widest gap of the parameters and both moments, absolute and over
    each kind's peak; and whether every one is the same bits."""
    import torch

    worst, rel, same = 0.0, 0.0, True
    for kind in ("params", "exp_avg", "exp_avg_sq"):
        got = [t.detach() for t in getattr(fused, kind)]
        want = [t.detach() for t in getattr(plain, kind)]
        peak = max(float(t.abs().max()) for t in want)
        for a, b in zip(got, want):
            gap = float((a - b).abs().max())
            worst = max(worst, gap)
            rel = max(rel, gap / max(peak, 1e-30))
            same = same and torch.equal(a, b)
    return worst, rel, same


def optim_grads(opt, seed: int, norm: float, channels_last: bool = False) -> list:
    """N(0, 1) gradients scaled to the global norm ``norm``; with
    ``channels_last`` every 4-d one in that memory order."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen, device=DEVICE) for p in opt.params]
    scale = norm / float(torch.sqrt(sum(g.square().sum() for g in grads)))
    grads = [g * scale for g in grads]
    if channels_last:
        grads = [g.contiguous(memory_format=torch.channels_last) if g.dim() == 4 else g
                 for g in grads]
    return grads


def phase_optim(seed: int) -> dict:
    """The optimizer kernels against the plain loops at the paper's widths
    (the module docstring's phase 4c)."""
    import copy

    import torch

    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.ops import fused_optim
    from multi_stylegan_torch.train.state import (
        make_discriminator_optimizer,
        make_generator_optimizer,
    )

    (gcfg, dcfg), cfg = train_configs("float32"), TrainingConfig()
    rows = {}
    for name, model, make in (
            ("G", random_generator(gcfg, seed + 40).to(DEVICE), make_generator_optimizer),
            ("D", random_discriminator(dcfg, seed + 41).to(DEVICE),
             make_discriminator_optimizer)):
        fused = make(model, cfg)
        plain = copy.deepcopy(fused)
        values = sum(p.numel() for p in fused.params)
        limit = cfg.grad_clip_norm
        row = {"leaves": len(fused.params), "values": values}
        # below the clip, the same bits; so again with channels-last
        # gradients; then a clipped step within rtol 1e-6
        for k, (step, norm, cl) in enumerate((("unclipped", 0.5 * limit, False),
                                              ("channels_last", 0.5 * limit, True),
                                              ("clipped", 10.0 * limit, False))):
            grads = optim_grads(fused, seed + 50 + k, norm, cl)
            launches = fused_optim.adam_launches
            applied = fused.step(grads)
            launches = fused_optim.adam_launches - launches
            fused_optim.clipped_adam_ref(grads=grads, **adam_tensors(plain))
            sync()
            worst, rel, same = optim_gap(fused, plain)
            row[step] = {"max_abs_err": worst, "max_rel_to_peak": rel, "bitwise": same,
                         "launches": launches}
            if not bool(applied) or launches != (2 if DEVICE == "cuda" else 0):
                raise AssertionError(f"optim {name} {step}: applied {bool(applied)}, "
                                     f"{launches} launches")
            if step != "clipped" and not same:
                raise AssertionError(f"optim {name} {step}: not the plain loop's bits "
                                     f"(max gap {worst})")
            for kind in ("params", "exp_avg", "exp_avg_sq"):
                got, want = getattr(fused, kind), getattr(plain, kind)
                peak = max(float(t.detach().abs().max()) for t in want)
                for a, b in zip(got, want):
                    torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6,
                                               atol=1e-6 * peak)
            if int(fused.count) != int(plain.count) or int(fused.count) != k + 1:
                raise AssertionError(f"optim {name} {step}: counts {int(fused.count)}, "
                                     f"{int(plain.count)}")
        grads = optim_grads(fused, seed + 60, 0.5 * limit)
        grads_cl = optim_grads(fused, seed + 60, 0.5 * limit, channels_last=True)
        row["ms"] = cuda_ms(lambda: fused.step(grads))
        row["ms_channels_last"] = cuda_ms(lambda: fused.step(grads_cl))
        row["plain_ms"] = cuda_ms(
            lambda: fused_optim.clipped_adam_ref(grads=grads, **adam_tensors(plain)))
        row["bound_ms"] = values * ADAM_BYTES / HBM_BYTES_PER_S * 1e3
        rows[f"adam.{name}"] = row
        if name == "G":
            params = list(model.parameters())
            ema = [p.detach().clone() + 0.01 for p in params]
            ema_plain = [e.clone() for e in ema]
            launches = fused_optim.ema_launches
            fused_optim.ema_update(ema, params, cfg.ema_decay)
            launches = fused_optim.ema_launches - launches
            fused_optim.ema_update_ref(ema_plain, params, cfg.ema_decay)
            sync()
            peak = max(float(e.abs().max()) for e in ema_plain)
            worst = max(float((a - b).abs().max()) for a, b in zip(ema, ema_plain))
            same = all(torch.equal(a, b) for a, b in zip(ema, ema_plain))
            if launches != (1 if DEVICE == "cuda" else 0):
                raise AssertionError(f"optim EMA: {launches} launches")
            for a, b in zip(ema, ema_plain):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * peak)
            rows["ema.G"] = {
                "values": values, "max_abs_err": worst, "bitwise": same, "launches": launches,
                "ms": cuda_ms(lambda: fused_optim.ema_update(ema, params, cfg.ema_decay)),
                "plain_ms": cuda_ms(
                    lambda: fused_optim.ema_update_ref(ema_plain, params, cfg.ema_decay)),
                "bound_ms": values * EMA_BYTES / HBM_BYTES_PER_S * 1e3}
            del ema, ema_plain
        del fused, plain, model, grads, grads_cl
        empty_cache()
    print("optim", json.dumps(rows), flush=True)
    return rows


def optim_kernel_rows(optim: dict, iterations: list) -> list:
    """The kernels line's entries for the optimizer kernels: the launches
    of ``iterations`` (phase 4's ``optimizer_launches``), times per f32
    regularised iteration (phase 4c's per step times its steps)."""
    def per_iteration(key):
        return sum(optim[f"adam.{m}"][key] * n for m, n in ITERATION_ADAM_STEPS.items())

    adam_err = max(optim[f"adam.{m}"][s]["max_abs_err"] for m in ITERATION_ADAM_STEPS
                   for s in ("unclipped", "channels_last", "clipped"))
    source = "multi_stylegan_torch/csrc/fused_optim.cu"
    return [
        {"name": "clipped_adam", "route": "cuda", "source": source, "replaces": None,
         "launches": sum(i["adam_launches"] for i in iterations), "max_abs_err": adam_err,
         "ms": per_iteration("ms"), "plain_ms": per_iteration("plain_ms"),
         "bound_ms": per_iteration("bound_ms"), "bound_by": "bytes", "library_ms": None},
        {"name": "ema_update", "route": "cuda", "source": source, "replaces": None,
         "launches": sum(i["ema_launches"] for i in iterations),
         "max_abs_err": optim["ema.G"]["max_abs_err"],
         "ms": ITERATION_EMA_UPDATES * optim["ema.G"]["ms"],
         "plain_ms": ITERATION_EMA_UPDATES * optim["ema.G"]["plain_ms"],
         "bound_ms": ITERATION_EMA_UPDATES * optim["ema.G"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]


def top_device_ops(prof, n: int = 15) -> list:
    """The ``n`` device kernels with the most time in a finished
    ``torch.profiler`` window, in ms."""
    import torch

    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return [{"name": k[:120], "ms": ms, "count": c} for k, ms, c in rows[:n]]


def tf32_regularisers(ts, state, real, draws) -> dict:
    """R1's D gradient and path length's G gradient of one state and one set
    of draws, with TF32 off (the CLIs' setting, ``utils/precision.py``) and
    then on (torch's default for cuDNN): each pass's time (R1 then path
    length, host clock around synchronised work; the first TF32 pass picks
    its cuDNN algorithms), and the TF32 gradients' max distance from the
    f32 ones against each gradient's peak.  No update is applied."""
    import torch

    from multi_stylegan_torch.train import losses
    from multi_stylegan_torch.train.steps import F32

    pld = ts.draw_path_length(state.generator, TRAIN_BATCH, draws)
    row, grads = {}, {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            sync()
            t0 = time.perf_counter()
            pen = losses.r1_penalty(lambda x: state.discriminator(x, **F32), real)
            r1 = torch.autograd.grad(pen, state.d_opt.params, allow_unused=True)
            del pen
            pl = ts.path_length_grads(state, pld)[0]
            sync()
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        row[f"r1_pl_ms_tf32_{'on' if tf32 else 'off'}"] = (time.perf_counter() - t0) * 1e3
        grads[tf32] = {"r1": [t for t in r1 if t is not None],
                       "path_length": [t for t in pl if t is not None]}
    for name in ("r1", "path_length"):
        row[f"{name}_grad_peak"] = flat_max(grads[False][name])
        row[f"{name}_grad_max_abs_diff"] = flat_max(
            a - b for a, b in zip(grads[True][name], grads[False][name]))
    print("tf32 regularisers", json.dumps(row), flush=True)
    del grads
    empty_cache()
    return row


def library_conv_backward(x_shape, taps, up, down, pad, g_nhwc):
    """cuDNN's backward-data of the depthwise conv the plain upfirdn2d runs
    (on its zero-stuffed, padded input): the yardstick for K4's backward."""
    import torch

    b, h, w, c = x_shape
    py0, py1, px0, px1 = pad
    kh, kw = taps.shape
    t = torch.empty((b, c, h * up + py0 + py1, w * up + px0 + px1), device=g_nhwc.device)
    t = t.contiguous(memory_format=torch.channels_last)
    wt = taps.flip(0, 1)[None, None].expand(c, 1, kh, kw).contiguous()
    g = g_nhwc.permute(0, 3, 1, 2)
    return lambda: torch.ops.aten.convolution_backward(
        g, t, wt, None, [down, down], [0, 0], [1, 1], False, [0, 0], c, [True, False, False])


def site_key(key):
    """A census key without its dtype: (kind, shape[, up, down, pad, taps])."""
    return key[:2] + key[3:]


def phase_grad_sites(seed: int, census, census_bf16) -> dict:
    """Every K1 and K3 call site of the regularised iterations, with its K2 /
    K4 gradients: correctness in f32 and bf16, times in f32 (kernel, plain,
    library) and bf16 (kernel).  ``census`` is the f32 iteration's launches
    by site, ``census_bf16`` the bf16 iteration's (its R1 and path length
    in f32)."""
    import torch

    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = {"K1": [], "K2": [], "K3": [], "K4": []}
    by_dtype = {name: {} for name in ("torch.float32", "torch.bfloat16")}
    for key, n in census_bf16.items():
        by_dtype[key[2]][site_key(key)] = n
    f32_sites = {site_key(k): n for k, n in census.items()}

    def launches(key):
        """(f32 iteration, bf16 iteration: its bf16 and its f32) launches."""
        k = site_key(key)
        return {"launches_per_iteration": f32_sites.get(k, 0),
                "launches_bf16_iteration_bf16": by_dtype["torch.bfloat16"].get(k, 0),
                "launches_bf16_iteration_f32": by_dtype["torch.float32"].get(k, 0)}

    def emit(kernel, row):
        rows[kernel].append(row)
        print("site", json.dumps({"kernel": kernel, **row}), flush=True)

    def sites(kind):
        keys = {site_key(k): k for k in list(census) + list(census_bf16) if k[0] == kind}
        return [keys[k] for k in sorted(keys)]

    largest = max((site_key(k)[1] for k in sites("K1")), key=math.prod)
    for key in sites("K1"):
        shape = key[1]
        c, m = shape[-1], math.prod(shape[:-1])
        fwd = {"shape": list(shape), **launches(key)}
        bwd = {"shape": list(shape), "part": "dx and db", **launches(("K2",) + key[1:])}
        # the double backward's form: dx only, an f32 addend over the rows
        dxo = {"shape": list(shape), "part": "dx only, addend",
               **launches(("K2",) + key[1:] + ("dx only",))}
        bias = torch.randn(c, generator=g, device=dev)
        add = torch.randn(c, generator=g, device=dev)
        for name, dt in dtypes.items():
            size = torch.tensor([], dtype=dt).element_size()
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            gy = torch.randn(shape, generator=g, device=dev).to(dt)
            fwd[f"max_abs_err_{name}"] = check(
                f"K1 {shape}", fused_act.fused_leaky_relu(x, bias, 0.2, 1.0),
                fused_act.fused_leaky_relu_ref(x, bias, 0.2, 1.0), name)
            out = fused_act.fused_leaky_relu_ref(x, bias, 0.2, 1.0)
            dx, db = fused_act.FusedLeakyReLUBackward.apply(gy, out, 0.2, 1.0)
            xr, br = x.clone().requires_grad_(True), bias.clone().requires_grad_(True)
            rdx, rdb = torch.autograd.grad(fused_act.fused_leaky_relu_ref(xr, br, 0.2, 1.0),
                                           (xr, br), gy)
            bwd[f"max_abs_err_{name}"] = max(check(f"K2 dx {shape}", dx, rdx, name),
                                             check(f"K2 db {shape}", db, rdb, name))
            if shape == largest:  # the bias sum's partial rows, added in a fixed order
                _, db2 = fused_act.FusedLeakyReLUBackward.apply(gy, out, 0.2, 1.0)
                bwd[f"db_same_bits_two_launches_{name}"] = bool(torch.equal(db, db2))
                if not bwd[f"db_same_bits_two_launches_{name}"]:
                    raise AssertionError(f"K2 db {shape} [{name}]: two launches differ")
            ggo = fused_act.FusedLeakyReLUDoubleBackward.apply(gy, add, out, 0.2, 1.0)
            rggo, _ = fused_act.fused_leaky_relu_grad_ref(gy, out, 0.2, 1.0, add, need_db=False)
            dxo[f"max_abs_err_{name}"] = check(f"K2 dx only {shape}", ggo, rggo, name)
            if name == "float32":
                fwd["ms"] = cuda_ms(lambda: fused_act.fused_leaky_relu(x, bias, 0.2, 1.0))
                fwd["plain_ms"] = cuda_ms(
                    lambda: fused_act.fused_leaky_relu_ref(x, bias, 0.2, 1.0), min_iters=1)
                fwd["library_ms"] = None
                bwd["ms"] = cuda_ms(lambda: fused_act.FusedLeakyReLUBackward.apply(gy, out, 0.2, 1.0))
                bwd["plain_ms"] = cuda_ms(
                    lambda: fused_act.fused_leaky_relu_grad_ref(gy, out, 0.2, 1.0), min_iters=1)
                bwd["library_ms"] = None  # no single PyTorch call gives dx and the bias sum
                dxo["ms"] = cuda_ms(
                    lambda: fused_act.FusedLeakyReLUDoubleBackward.apply(gy, add, out, 0.2, 1.0))
                dxo["plain_ms"] = cuda_ms(lambda: fused_act.fused_leaky_relu_grad_ref(
                    gy, out, 0.2, 1.0, add, need_db=False), min_iters=1)
                dxo["library_ms"] = None
                sfx = ""
            else:
                fwd["ms_bf16"] = cuda_ms(lambda: fused_act.fused_leaky_relu(x, bias, 0.2, 1.0))
                bwd["ms_bf16"] = cuda_ms(
                    lambda: fused_act.FusedLeakyReLUBackward.apply(gy, out, 0.2, 1.0))
                dxo["ms_bf16"] = cuda_ms(
                    lambda: fused_act.FusedLeakyReLUDoubleBackward.apply(gy, add, out, 0.2, 1.0))
                sfx = "_bf16"
            fwd["bound_ms" + sfx], fwd["bound_by" + sfx] = bound_ms(
                2 * m * c * size + c * 4, 4 * m * c)
            # g and out read, dx written; the bias sum written or the addend read
            for row in (bwd, dxo):
                row["bound_ms" + sfx], row["bound_by" + sfx] = bound_ms(
                    3 * m * c * size + c * 4, 4 * m * c)
            del x, gy, out, dx, db, rdx, rdb, ggo, rggo
        emit("K1", fwd)
        emit("K2", bwd)
        emit("K2", dxo)

    for key in sites("K3"):
        _, shape, _, up, down, pad, ksize = key
        b, h, w, c = shape
        taps = torch.randn(ksize, generator=g, device=dev)
        pad_xy = (pad[2], pad[3], pad[0], pad[1])
        ho = up_mod.out_size(h, up, down, pad[0], pad[1], ksize[0])
        wo = up_mod.out_size(w, up, down, pad[2], pad[3], ksize[1])
        gpad = up_mod._adjoint_pads(ksize, up, down, pad, (h, w), (ho, wo))
        out_shape = (b, ho, wo, c)
        common = {"shape": list(shape), "up": up, "down": down, "pad": list(pad)}
        fwd = dict(common, **launches(key))
        bwd = dict(common, part="backward", **launches(("K4", out_shape, key[2], down, up, gpad, ksize)))
        dbl = dict(common, part="double backward", **launches(("K4", shape, key[2], up, down, pad, ksize)))
        for name, dt in dtypes.items():
            size = torch.tensor([], dtype=dt).element_size()
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            gy = torch.randn(out_shape, generator=g, device=dev).to(dt)
            gg = torch.randn(shape, generator=g, device=dev).to(dt)
            y = up_mod.upfirdn2d(x, taps, up, down, pad_xy)
            fwd[f"max_abs_err_{name}"] = check(
                f"K3 {key}", y, up_mod.upfirdn2d_ref(x, taps, up, down, pad_xy), name)
            gx = up_mod.UpFirDn2dBackward.apply(gy, taps, up, down, pad, (h, w), (ho, wo))
            xr = x.clone().requires_grad_(True)
            gr = gy.clone().requires_grad_(True)
            (rgx,) = torch.autograd.grad(up_mod.upfirdn2d_ref(xr, taps, up, down, pad_xy), xr, gr,
                                         create_graph=True)
            bwd[f"max_abs_err_{name}"] = check(f"K4 backward {key}", gx, rgx, name)
            ggy = up_mod.UpFirDn2d.apply(gg, taps, up, down, pad, True)
            (rggy,) = torch.autograd.grad(rgx, gr, gg)
            dbl[f"max_abs_err_{name}"] = check(f"K4 double backward {key}", ggy, rggy, name)
            flip = taps.flip(0, 1).contiguous()
            gpad_xy = (gpad[2], gpad[3], gpad[0], gpad[1])
            used_f = (upfirdn_taps_used(h, ho, up, down, pad[0], ksize[0])
                      * upfirdn_taps_used(w, wo, up, down, pad[2], ksize[1]))
            used_b = (upfirdn_taps_used(ho, h, down, up, gpad[0], ksize[0])
                      * upfirdn_taps_used(wo, w, down, up, gpad[2], ksize[1]))
            sym = pad[0] == pad[2] and pad[1] == pad[3]
            for row, fn, plain, lib, used, n_in, n_out in (
                    (fwd, lambda: up_mod.upfirdn2d(x, taps, up, down, pad_xy),
                     lambda: up_mod.upfirdn2d_ref(x, taps, up, down, pad_xy),
                     lambda: library_upfirdn(x, taps, up, (pad[0], pad[1])) if sym else None,
                     used_f, x.numel(), y.numel()),
                    (bwd, lambda: up_mod.UpFirDn2dBackward.apply(
                        gy, taps, up, down, pad, (h, w), (ho, wo)),
                     lambda: up_mod.upfirdn2d_ref(gy, flip, down, up, gpad_xy),
                     lambda: library_conv_backward(shape, taps, up, down, pad, gy),
                     used_b, gy.numel(), x.numel()),
                    (dbl, lambda: up_mod.UpFirDn2d.apply(gg, taps, up, down, pad, True),
                     lambda: up_mod.upfirdn2d_ref(gg, taps, up, down, pad_xy),
                     lambda: library_upfirdn(gg, taps, up, (pad[0], pad[1])) if sym else None,
                     used_f, x.numel(), y.numel())):
                if name == "float32":
                    row["ms"] = cuda_ms(fn)
                    row["variant"] = up_mod.last_variant
                    row["plain_ms"] = cuda_ms(plain, min_iters=1)
                    lib = lib()
                    row["library_ms"] = cuda_ms(lib, min_iters=1) if lib is not None else None
                    sfx = ""
                else:
                    row["ms_bf16"] = cuda_ms(fn)
                    row["variant_bf16"] = up_mod.last_variant
                    sfx = "_bf16"
                row["bound_ms" + sfx], row["bound_by" + sfx] = bound_ms(
                    (n_in + n_out) * size + taps.numel() * 4, 2 * used * b * c)
            del x, gy, gg, y, gx, rgx, ggy, rggy, xr, gr
        # every model site but the C = 3 skip upsamples has a tiled form
        variants = [r[v] for r in (fwd, bwd, dbl) for v in ("variant", "variant_bf16")]
        if c != 3 and "general" in variants:
            raise AssertionError(f"K3/K4 site {key} took the general variant: {variants}")
        emit("K3", fwd)
        emit("K4", bwd)
        emit("K4", dbl)
    empty_cache()
    for label, field, cen in (("f32", ("launches_per_iteration",), census),
                              ("bf16", ("launches_bf16_iteration_bf16",
                                        "launches_bf16_iteration_f32"), census_bf16)):
        counted = {k: sum(r[f] for r in rows[k] for f in field) for k in rows}
        total = {k: sum(v for key, v in cen.items() if key[0] == k) for k in rows}
        if counted != total:
            raise AssertionError(f"{label} site rows cover {counted} launches, the census {total}")
    return rows, k2_edge(g)


K2_EDGE_ELEMENTS = 2**31 + 8 * 512  # [4194312, 512]: M * C just over 2^31


def k2_edge(g) -> dict:
    """K2 in bf16 on [M, 512] with M * C just over 2^31 (64-bit offsets):
    the last rows of dx against the plain version on those rows, and the
    bias sum against the plain version's, taken in slices to keep it
    cheap."""
    import torch

    from multi_stylegan_torch.ops import fused_act

    dev = g.device
    c = 512
    m = K2_EDGE_ELEMENTS // c
    gy = torch.randn((m, c), generator=g, device=dev, dtype=torch.bfloat16)
    out = torch.randn((m, c), generator=g, device=dev, dtype=torch.bfloat16)
    dx, db = fused_act.FusedLeakyReLUBackward.apply(gy, out, 0.2, 1.0)
    tail = slice(m - 4096, m)
    err = check("K2 edge dx (last rows)", dx[tail],
                fused_act.fused_leaky_relu_grad_ref(gy[tail], out[tail], 0.2, 1.0)[0], "bfloat16")
    rdb = torch.zeros(c, device=dev)
    for lo in range(0, m, 1 << 20):
        rdb += fused_act.fused_leaky_relu_grad_ref(gy[lo:lo + (1 << 20)], out[lo:lo + (1 << 20)],
                                                   0.2, 1.0)[1]
    err = max(err, check("K2 edge db", db, rdb, "bfloat16"))
    row = {"kernel": "K2", "shape": [m, c], "elements": m * c, "max_abs_err_bfloat16": err,
           "ms_bf16": cuda_ms(lambda: fused_act.FusedLeakyReLUBackward.apply(gy, out, 0.2, 1.0))}
    row["bound_ms_bf16"], row["bound_by_bf16"] = bound_ms(3 * m * c * 2 + c * 4, 4 * m * c)
    print("edge", json.dumps(row), flush=True)
    del gy, out, dx, db, rdb
    empty_cache()
    return row


class RecordingDraws:
    """Draws from a CPU ``TorchDraws``, recorded for replay on the card."""

    def __init__(self, inner):
        self.inner, self.records = inner, []

    def __getattr__(self, kind):
        fn = getattr(self.inner, kind)

        def call(*a):
            out = fn(*a)
            self.records.append(out)
            return out
        return call


class ReplayDraws:
    """Hands out recorded draws in order, moved to ``device``."""

    def __init__(self, records, device):
        self.records, self.device, self.i = records, device, 0

    def _next(self, *a):
        import dataclasses

        import torch

        out = self.records[self.i]
        self.i += 1

        def move(v):
            if isinstance(v, torch.Tensor):
                return v.to(self.device)
            if isinstance(v, (list, tuple)):
                return type(v)(move(u) for u in v)
            if dataclasses.is_dataclass(v):
                return type(v)(**{f.name: move(getattr(v, f.name)) for f in dataclasses.fields(v)})
            return v
        return move(out)

    def __getattr__(self, kind):
        return self._next


def d_step_gradients(ts, state, real, draws) -> dict:
    """D's parameter gradients of the D step's losses (wrong order on)."""
    import torch

    losses_ = ts.d_losses(state, real, True, draws)[0]
    return {"d_step": torch.autograd.grad(sum(losses_.values()),
                                          list(state.discriminator.parameters()))}


def cpu_and_card_gradients(seed: int, batch: int, cpu_dtypes, card_dtype: str,
                           grads=d_step_gradients, fft: bool = False, sequential: bool = False,
                           p: float = 0.3):
    """``grads(ts, state, real, draws)`` ({name: gradients}) of one set of
    random weights and draws on the CPU (plain versions, no remat: remat
    changes no value, only time) in each of ``cpu_dtypes`` and on the card
    in ``card_dtype``, ADA at ``p``; returns ({dtype: cpu gradients}, card
    gradients on the host, host seconds)."""
    import torch

    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.models.discriminator import Discriminator
    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import TrainStep

    gcfg, dcfg = train_configs(card_dtype, fft=fft)
    cfg = TrainingConfig(batch_size=batch, ada_sequential_warps=sequential)
    ts = TrainStep(cfg)
    src_g, src_d = random_generator(gcfg, seed).train(), random_discriminator(dcfg, seed + 1)
    real = real_batch(batch, gcfg.resolution, seed + 2)
    rec = RecordingDraws(TorchDraws(torch.Generator().manual_seed(seed + 3)))
    ref, t0 = {}, time.perf_counter()
    for dtype in cpu_dtypes:
        g = Generator(dataclasses.replace(gcfg, compute_dtype=dtype, remat=False))
        g.load_state_dict(src_g.state_dict())
        d = Discriminator(dataclasses.replace(dcfg, compute_dtype=dtype, remat=False))
        d.load_state_dict(src_d.state_dict())
        state = create_train_state(g, d, cfg)
        state.ada.p = torch.tensor(p)
        draws = rec if not ref else ReplayDraws(rec.records, torch.device("cpu"))
        ref[dtype] = grads(ts, state, real, draws)
    host_s = time.perf_counter() - t0
    state = create_train_state(src_g.to(DEVICE), src_d.to(DEVICE), cfg)
    state.ada.p = torch.tensor(p, device=DEVICE)
    got = grads(ts, state, real.to(DEVICE), ReplayDraws(rec.records, torch.device(DEVICE)))
    got = {name: [a.detach().cpu() for a in g] for name, g in got.items()}
    del state
    empty_cache()
    return ref, got, host_s


def flat_max(tensors) -> float:
    return max(float(t.detach().float().abs().max()) for t in tensors)


def train_parity_gradients(ts, state, real, draws) -> dict:
    """The D step's, R1's and path length's parameter gradients."""
    import torch

    from multi_stylegan_torch.train import losses

    d_params, g_params = list(state.discriminator.parameters()), list(state.generator.parameters())
    out = d_step_gradients(ts, state, real, draws)
    out["r1"] = torch.autograd.grad(losses.r1_penalty(state.discriminator, real), d_params)
    pen = ts.path_length_loss(state, real.shape[0], draws)[0]
    out["path_length"] = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(
        g_params, torch.autograd.grad(pen, g_params, allow_unused=True))]
    return out


def phase_train_parity(seed: int) -> dict:
    """GPU vs CPU gradients at full width, batch 2, same weights and draws."""
    ref, got, host_s = cpu_and_card_gradients(seed + 30, 2, ("float32",), "float32",
                                              train_parity_gradients)
    row = {"host_seconds": host_s}
    for name, r in ref["float32"].items():
        peak, err = flat_max(r), flat_max(a - b for a, b in zip(got[name], r))
        row[name] = {"max_abs_err": err, "peak": peak}
        if not (math.isfinite(err) and peak > 0 and err <= GRAD_TOL * peak):
            raise AssertionError(f"GPU vs CPU {name} gradient: max abs err {err}, peak {peak}")
    print("slice train parity", json.dumps(row), flush=True)
    return row


# --------------------------------------------------------------- train run


TRAIN_RUN_EPOCHS = 1  # cut from 3 to 2, then to 1, for the later phases' time
TRAIN_RUN_SAMPLES = 48  # FID / FVD / IS samples here; the protocol takes 5000
PROTOCOL_SAMPLES = 5000
GRID_BATCH = 15  # the fixed validation latents of the sample grids


class MethodTimer:
    """Host seconds of every call of some class methods while active (each
    call ends with a device sync)."""

    def __init__(self, *targets):
        from collections import defaultdict

        self.targets = targets
        self.seconds = defaultdict(list)

    def __enter__(self):
        self.originals = [(cls, name, cls.__dict__[name]) for cls, name in self.targets]
        for cls, name, orig in self.originals:

            def timed(obj, *a, _orig=orig, _key=f"{cls.__name__}.{name}", **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(obj, *a, **kw)
                finally:
                    sync()
                    self.seconds[_key].append(time.perf_counter() - t0)
            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self.originals:
            setattr(cls, name, orig)


class BatchVariants:
    """The upfirdn2d variant of every launch on a tensor of batch ``batch``
    (the sample grids' 15, the interpolation's 32), by wrapping the launch
    function (counts untouched)."""

    def __init__(self, batch: int):
        self.batch = batch

    def __enter__(self):
        from multi_stylegan_torch.ops import upfirdn2d as up_mod

        self.mod, self.orig, self.seen = up_mod, up_mod._upfirdn2d_cuda, {}

        def k3(x, kernel, up, down, pad, adjoint=False):
            out = self.orig(x, kernel, up, down, pad, adjoint)
            if x.shape[0] == self.batch:
                self.seen[(tuple(x.shape), up, down, tuple(pad))] = self.mod.last_variant
            return out
        up_mod._upfirdn2d_cuda = k3
        return self

    def __exit__(self, *exc):
        self.mod._upfirdn2d_cuda = self.orig

    def check(self, what: str) -> None:
        """Fails unless a launch was seen and none but the C = 3 skips took
        the general form."""
        bad = {k: v for k, v in self.seen.items() if v == "general" and k[0][-1] != 3}
        if not self.seen or bad:
            raise AssertionError(f"{what} sites on the general variant: {bad or 'none seen'}")


def random_eval_net(module, seed: int):
    """Random weights that keep the features input-dependent 40 layers down:
    He-scaled convs, near-identity batch norms, and an ``fc`` scaled so that
    the class softmax spreads (PyTorch's default init collapses every image
    to one feature vector, FID to 0 and IS to 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                gain = 3e3 if name.startswith("fc.") else 2.0
                p.copy_(torch.randn(p.shape, generator=g) * (gain / p[0].numel()) ** 0.5)
            elif name.endswith("bn.weight"):
                p.copy_(1 + 0.05 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.1 * torch.rand(buf.shape, generator=g))
    return module


def phase_train_run(seed: int, iteration_ops: list):
    """The training CLI's whole run at the flagship config on a TLFM TIFF
    tree: trap weights, logger, sample grids, checkpoints, FID / FVD / IS
    with random-weight nets loaded from files, a torch.profiler trace of
    the run's last step.  ``iteration_ops`` (the profiled regularised
    iteration's top device ops) goes into the printed line beside the
    run's."""
    import shutil
    import warnings

    import torch

    from multi_stylegan_torch.cli import train
    from multi_stylegan_torch.data.pipeline import make_loader
    from multi_stylegan_torch.data.tlfm import TLFMDataset, write_tlfm_tree
    from multi_stylegan_torch.eval import metrics
    from multi_stylegan_torch.eval.i3d import InceptionI3D
    from multi_stylegan_torch.eval.inception_v3 import InceptionV3
    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.train.loop import Trainer
    from multi_stylegan_torch.train.steps import TrainStep

    gcfg, _ = train_configs()
    tmp = tempfile.mkdtemp(prefix="train_run_")
    env = {"MSG_TPU_INCEPTION_PT": os.path.join(tmp, "inception.pt"),
           "MSG_TPU_I3D_PT": os.path.join(tmp, "i3d.pt")}
    saved_env = {k: os.environ.get(k) for k in env}
    try:
        # one position, one trap, 3 z x 18 timesteps of BF, GFP, RFP: 48 sequences
        t0 = time.perf_counter()
        tree = write_tlfm_tree(os.path.join(tmp, "tlfm"), n_traps=1, n_times=18,
                               size=gcfg.resolution[0], seed=seed)
        files = [os.path.join(tree, "Pos0", f) for f in os.listdir(os.path.join(tree, "Pos0"))]
        tree_row = {"files": len(files), "mb": sum(map(os.path.getsize, files)) / 2**20,
                    "write_s": time.perf_counter() - t0}
        torch.save(random_eval_net(InceptionV3(), seed).state_dict(), env["MSG_TPU_INCEPTION_PT"])
        torch.save(random_eval_net(InceptionI3D(num_classes=400), seed + 1).state_dict(),
                   env["MSG_TPU_I3D_PT"])
        os.environ.update(env)
        # a batch of 24 read and collated in this process (the workers' job)
        dataset = TLFMDataset(tree, no_rfp=True)
        batches = iter(make_loader(dataset, TRAIN_BATCH, seed=seed))
        t0 = time.perf_counter()
        next(batches)
        loader_ms = (time.perf_counter() - t0) * 1e3

        exp, prof = os.path.join(tmp, "experiment"), os.path.join(tmp, "profile")
        common = CONFIG_ARGS + [
            "--path_to_data", tree, "--trap_weights", "--batch_size", str(TRAIN_BATCH),
            "--seed", str(seed), "--device", DEVICE, "--experiment_path", exp]
        # one validation, at the last epoch: each FID pass spends ~25-60 s in
        # scipy's sqrtm of two 2048 x 2048 products on the host, and four of
        # them took 290 s of a 906 s run (NVIDIA H100 80GB HBM3, 700 W); trap
        # weights and the wrong-order schedule from the run's start (their
        # defaults, 0.25 and 0.75 of the epochs, fall after its one epoch)
        overrides = dict(checkpoint_every_n_epochs=1, validate_every_n_epochs=TRAIN_RUN_EPOCHS,
                         wrong_order_start=0.0, trap_weight_start=0.0)
        orders, orig_main_step = [], TrainStep.main_step

        def main_step(self, state, real, flags, draws):
            orders.append(flags.wrong_order)
            return orig_main_step(self, state, real, flags, draws)
        timer = MethodTimer((Trainer, "_save_sample_grids"), (Trainer, "save_checkpoint"),
                            (metrics.FID, "__call__"), (metrics.FVD, "__call__"),
                            (metrics.IS, "__call__"))
        # each host Frechet distance of the validation, with its inputs
        fd_calls, host_fd = [], metrics.frechet_distance

        def recorded_fd(real, fake):
            t0 = time.perf_counter()
            value = host_fd(real, fake)
            fd_calls.append((real, fake, value, time.perf_counter() - t0))
            return value
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught, timer, BatchVariants(GRID_BATCH) as grids:
            warnings.simplefilter("always")
            TrainStep.main_step, metrics.frechet_distance = main_step, recorded_fd
            try:
                zero_counts()
                run = train.main(common + ["--epochs", str(TRAIN_RUN_EPOCHS), "--profile_dir", prof],
                                 config_overrides=overrides, validation_samples=TRAIN_RUN_SAMPLES)
                counts = read_counts()
            finally:
                TrainStep.main_step, metrics.frechet_distance = orig_main_step, host_fd
        peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else None
        trainer = run["trainer"]
        failed_saves = [str(w.message) for w in caught if "save failed" in str(w.message)]
        if failed_saves:
            raise AssertionError(f"guarded saves failed: {failed_saves}")
        steps_per_epoch = len(dataset) // TRAIN_BATCH
        steps = TRAIN_RUN_EPOCHS * steps_per_epoch
        if not run["finite"] or run["steps"] != steps or trainer.state.step != steps:
            raise AssertionError(f"train run: {run['steps']} steps, finite={run['finite']}")
        if not all(counts.values()):
            raise AssertionError(f"train run: a kernel was never launched: {counts}")
        grids.check("batch-15 grid")
        if sum(orders) != steps_per_epoch * (TRAIN_RUN_EPOCHS - math.ceil(
                overrides["wrong_order_start"] * TRAIN_RUN_EPOCHS)):
            raise AssertionError(f"wrong order ran in {sum(orders)} of {len(orders)} steps")

        # what the run left in its experiment directory
        logger = trainer.logger
        plots = os.listdir(logger.path_plots)
        if len(plots) != TRAIN_RUN_EPOCHS * 4 * GRID_BATCH * 2:
            raise AssertionError(f"{len(plots)} grid PNGs")
        streams = set(run["history"][0]) - {"seconds", "data_wait_seconds"}
        streams |= {"seqs_per_sec"} | {f"{m}_{c}" for m in ("FID", "FVD", "IS") for c in ("bf", "gfp")}
        missing = [s for s in streams if not os.path.isfile(os.path.join(logger.path_metrics, f"{s}.npy"))]
        if missing or not os.path.isfile(os.path.join(logger.path_hyperparameters,
                                                      "hyperparameter.txt")):
            raise AssertionError(f"missing logger files: {missing or 'hyperparameter.txt'}")
        scores = {k: v for k, v in logger.metrics.items() if k.split("_")[0] in ("FID", "FVD", "IS")}
        n_validations = TRAIN_RUN_EPOCHS // overrides["validate_every_n_epochs"]
        if len(scores) != 6 or not all(len(v) == n_validations and all(map(math.isfinite, v))
                                       for v in scores.values()):
            raise AssertionError(f"validation scores: {scores}")

        # two of the last epoch's fixed-noise EMA grid samples vs the CPU
        z1, z2 = trainer.validation_noise
        gpu = trainer.sample(z1, z2, trainer.grid_generator(TRAIN_RUN_EPOCHS - 1),
                             randomize_noise=False)[:2].cpu()
        inject = int(torch.randint(1, gcfg.n_latents - 1, (1,),
                                   generator=trainer.grid_generator(TRAIN_RUN_EPOCHS - 1),
                                   device=trainer.device))
        cpu_g = Generator(gcfg)
        cpu_g.load_state_dict({k: v.cpu() for k, v in trainer.state.g_ema.state_dict().items()})
        with torch.no_grad():
            ref = cpu_g.eval()(z1[:2].cpu(), z2[:2].cpu(), inject_index=inject,
                               randomize_noise=False)
        grid_peak = float(ref.abs().max())
        grid_err = float((gpu - ref).abs().max())
        if not (math.isfinite(grid_err) and grid_err <= SAMPLE_TOL * max(1.0, grid_peak)):
            raise AssertionError(f"grid sample GPU vs CPU: max abs err {grid_err}, peak {grid_peak}")

        if trainer.trace is None or trainer.trace.path is None:
            raise AssertionError("no profiler trace of the run's last step")
        top_ops = top_device_ops(trainer.trace.prof)
        frechet = frechet_rows(fd_calls)
        print("frechet", json.dumps(frechet), flush=True)
        ckpt_mb = os.path.getsize(trainer.ckpt.path(steps)) / 2**20
        history = run["history"]
        del run, trainer, cpu_g
        empty_cache()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)

    secs = timer.seconds
    metric_s = {m: secs[f"{m}.__call__"] for m in ("FID", "FVD", "IS")}
    row = {
        "tree": tree_row, "sequences": len(dataset), "steps": steps,
        "wrong_order_steps": sum(orders),
        "loader_ms_per_batch": loader_ms,
        "data_wait_s": [m["data_wait_seconds"] for m in history],
        "step_s": [m["seconds"] for m in history],
        "grid_save_s": secs["Trainer._save_sample_grids"],
        "checkpoint_save_s": secs["Trainer.save_checkpoint"],
        "checkpoint_mb": ckpt_mb,
        "metric_s": metric_s, "metric_samples": TRAIN_RUN_SAMPLES,
        "metric_s_scaled_to_5000": {m: [s * PROTOCOL_SAMPLES / TRAIN_RUN_SAMPLES for s in v]
                                    for m, v in metric_s.items()},
        "scores_last": {k: v[-1] for k, v in scores.items()},
        "peak_memory_gib": peak, "launches": counts,
        "grid_sites": {str(k): v for k, v in grids.seen.items()},
        "grid_sample_max_abs_err": grid_err, "grid_sample_peak": grid_peak,
        "top_device_ops_last_step": top_ops, "frechet": frechet,
        "top_device_ops_regularised_iteration": iteration_ops,
    }
    print("train_run", json.dumps(row), flush=True)
    return counts, row


# ----------------------------------------------------------------- slice 5


def phase_bf16_parity(seed: int) -> dict:
    """The bf16 D-step gradient on the card against the CPU's bf16 plain
    path at full width, batch 1, with the self-calibrating tolerance:
    max |card - cpu bf16| <= max(4 max |cpu bf16 - cpu f32|, 2^-8 peak)."""
    ref, got, host_s = cpu_and_card_gradients(seed + 40, 1, ("float32", "bfloat16"), "bfloat16")
    ref = {dtype: r["d_step"] for dtype, r in ref.items()}
    err = flat_max(a - b for a, b in zip(got["d_step"], ref["bfloat16"]))
    own = flat_max(a.float() - b for a, b in zip(ref["bfloat16"], ref["float32"]))
    peak = flat_max(ref["float32"])
    limit = max(4 * own, 2.0 ** -8 * peak)
    row = {"max_abs_err": err, "cpu_bf16_vs_f32": own, "peak": peak, "limit": limit,
           "host_seconds": host_s}
    print("bf16 parity", json.dumps(row), flush=True)
    if not (math.isfinite(err) and peak > 0 and err <= limit):
        raise AssertionError(f"bf16 D-step gradient card vs CPU: {row}")
    return row


def phase_sequential_fft(seed: int):
    """One main step with ADA's sequential warps (p = 0.5) and the fft
    discriminator, f32, batch 24: finite, moved, exact launches; then its
    D-step gradient on the card against the CPU's at batch 2."""
    import torch

    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import StepFlags, TrainStep

    gcfg, dcfg = train_configs(fft=True)
    cfg = TrainingConfig(ada_sequential_warps=True)
    gen = random_generator(gcfg, seed + 60).train().to(DEVICE)
    disc = random_discriminator(dcfg, seed + 61).to(DEVICE)
    state = create_train_state(gen, disc, cfg)
    state.ada.p = torch.tensor(0.5, device=DEVICE)
    ts = TrainStep(cfg, top_k_start_iteration=0, top_k_final_iteration=2)
    draws = TorchDraws(torch.Generator(device=DEVICE).manual_seed(seed + 62))
    real = real_batch(TRAIN_BATCH, gcfg.resolution, seed + 63).to(DEVICE)
    before = [p.detach().clone() for p in disc.parameters()]
    per_sub = {}

    def counted(name, fn):
        def run(*a, **kw):
            c0 = read_counts()
            out = fn(*a, **kw)
            c1 = read_counts()
            per_sub[name] = {k: c1[k] - c0[k] for k in c1}
            return out
        return run

    for name in ("d_step", "cut_mix_step", "g_step"):
        setattr(ts, name, counted(name, getattr(ts, name)))
    zero_counts()
    t0 = time.perf_counter()
    metrics = ts.main_step(state, real, StepFlags(wrong_order=True, do_cut_mix=True), draws)
    counts = read_counts()
    ms = (time.perf_counter() - t0) * 1e3
    host = {k: float(v) for k, v in metrics.items()}
    if not all(map(math.isfinite, host.values())) or not all_finite(gen) or not all_finite(disc):
        raise AssertionError(f"sequential + fft main step: non-finite {host}")
    if any(torch.equal(a, b) for a, b in zip(before, disc.parameters())):
        raise AssertionError("sequential + fft: a D parameter did not move")
    for name, want in per_sub.items():
        if want != expected_launches(gcfg, dcfg, name, wrong_order=(name == "d_step")):
            raise AssertionError(f"sequential + fft {name}: launches {want}")
    del state, gen, disc
    empty_cache()
    ref, got, host_s = cpu_and_card_gradients(seed + 64, 2, ("float32",), "float32",
                                              fft=True, sequential=True, p=0.5)
    err = flat_max(a - b for a, b in zip(got["d_step"], ref["float32"]["d_step"]))
    peak = flat_max(ref["float32"]["d_step"])
    row = {"main_step_ms": ms, "launches": counts, "launches_by_sub_step": per_sub,
           "metrics": host, "d_grad_max_abs_err": err, "d_grad_peak": peak,
           "host_seconds": host_s}
    print("sequential fft", json.dumps(row), flush=True)
    if not (math.isfinite(err) and peak > 0 and err <= GRAD_TOL * peak):
        raise AssertionError(f"sequential + fft D-step gradient card vs CPU: {err} vs peak {peak}")
    return counts, row


def phase_pl_chunked(seed: int) -> dict:
    """The Trainer's path-length ladder (train/robust.py) at batch 24
    (path-length batch 12), from one state and one set of draws: its grads
    stage unchunked, and demoted to 4 chunks by out-of-memory errors
    injected at 1 and 2 chunks; the gradients within 1e-4 of the peak, each
    stage's time and peak memory.  Then the Trainer's whole update at 4
    chunks (draws, grads, G step, EMA): its metrics, finite and moved G
    parameters, 4 times the unchunked update's launches."""
    import torch

    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.robust import RobustPathLength
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import TrainStep

    gcfg, dcfg = train_configs()
    cfg = TrainingConfig()
    gen = random_generator(gcfg, seed + 50).train().to(DEVICE)
    state = create_train_state(gen, random_discriminator(dcfg, seed + 51).to(DEVICE), cfg)
    state.mean_path_length.fill_(0.5)
    ts, squeezed, reports = TrainStep(cfg), TrainStep(cfg), []

    def path_length_grads(state, pld, n_chunks=1):
        if n_chunks < 4:
            raise torch.cuda.OutOfMemoryError(f"injected: no room for {n_chunks} chunk(s)")
        return TrainStep.path_length_grads(squeezed, state, pld, n_chunks)
    squeezed.path_length_grads = path_length_grads
    ladders = {1: RobustPathLength(ts), 4: RobustPathLength(squeezed, report=reports.append)}
    draws = TorchDraws(torch.Generator(device=DEVICE).manual_seed(seed + 52))
    pld = ts.draw_path_length(gen, TRAIN_BATCH, draws)
    row, out = {"path_length_batch": int(pld.probe.shape[0])}, {}
    for n, ladder in ladders.items():
        empty_cache()
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out[n] = ladder.grads(state, pld)
        sync()
        row[f"grads_ms_{n}_chunks"] = (time.perf_counter() - t0) * 1e3
        row[f"peak_memory_gib_{n}_chunks"] = (torch.cuda.max_memory_allocated() / 2**30
                                              if DEVICE == "cuda" else None)
        if out[n] is None or ladder.chunks != n:
            raise AssertionError(f"path-length ladder ran at {ladder.chunks} chunks, not {n}")
    if len(reports) != 2:
        raise AssertionError(f"path-length ladder demotions: {reports}")
    ref = [torch.zeros_like(p) if g is None else g for p, g in zip(state.g_opt.params, out[1][0])]
    got = [torch.zeros_like(p) if g is None else g for p, g in zip(state.g_opt.params, out[4][0])]
    peak, err = flat_max(ref), flat_max(a - b for a, b in zip(got, ref))
    row.update(grad_max_abs_err=err, grad_peak=peak, path_length=[float(out[n][2]) for n in (1, 4)])
    del out, ref, got

    before = [p.detach().clone() for p in gen.parameters()]
    zero_counts()
    sync()
    t0 = time.perf_counter()
    pen, pl, metrics = ladders[4](state, draws)
    sync()
    counts = read_counts()
    want = {k: 4 * v for k, v in expected_launches(gcfg, dcfg, "path_length_update").items()}
    moved = sum(not torch.equal(a, b) for a, b in zip(before, gen.parameters()))
    row.update(update_ms_4_chunks=(time.perf_counter() - t0) * 1e3, update_launches=counts,
               update_metrics={k: float(v) for k, v in metrics.items()},
               update_path_length=float(pl), g_params_moved=moved)
    print("pl chunked", json.dumps(row), flush=True)
    if not (math.isfinite(err) and peak > 0 and err <= 1e-4 * peak):
        raise AssertionError(f"chunked path length gradient: {err}, peak {peak}")
    if (row["update_metrics"] != {"path_length_chunks": 4.0, "path_length_skipped": 0.0}
            or counts != want or not (math.isfinite(float(pen)) and math.isfinite(float(pl)))
            or not all_finite(gen) or moved == 0):
        raise AssertionError(f"the Trainer's path-length update at 4 chunks: {row} "
                             f"(launches expected {want})")
    del state, gen, before
    empty_cache()
    return counts, row


def snapshot(train_state: dict) -> dict:
    """The tensors of a checkpoint's ``train_state`` the reference format
    carries, copied to the host."""
    flat = {"step": train_state["step"]}
    for name in ("generator", "g_ema", "discriminator"):
        for k, v in train_state[name].items():
            flat[f"{name}.{k}"] = v.detach().cpu().clone()
    for name in ("g_opt", "d_opt"):
        opt = train_state[name]
        for i, (m, v) in enumerate(zip(opt["exp_avg"], opt["exp_avg_sq"])):
            flat[f"{name}.exp_avg.{i}"] = m.detach().cpu().clone()
            flat[f"{name}.exp_avg_sq.{i}"] = v.detach().cpu().clone()
        flat[f"{name}.count"] = int(opt["count"])
    return flat


def launches_per_g_forward(gcfg) -> dict:
    """K1 / K3 launches of one sampling forward from one latent (no mixing)."""
    s = model_sites(gcfg, None)
    return {"K1": gcfg.depth_style_mapping + s["g_styled"], "K2": 0, "K3": s["g_k3"], "K4": 0}


def phase_reference(seed: int, trained_dir: str, work: str):
    """The trained bf16 iteration's checkpoint -> ``cli.export`` -> a
    reference-format .pt -> ``cli.convert`` -> the trainer's checkpoint,
    bitwise the source for everything the format carries; then the training
    CLI from the .pt (Adam moments installed) and the sampling CLI on the
    models directory it writes."""
    import torch

    from multi_stylegan_torch.cli import convert, export, sample, train
    from multi_stylegan_torch.io.checkpoint import CheckpointManager

    gcfg, dcfg = train_configs()
    source = snapshot(CheckpointManager(trained_dir).load()["train_state"])
    pt = os.path.join(work, "reference.pt")
    t0 = time.perf_counter()
    export.main([trained_dir, pt] + CONFIG_ARGS)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = torch.load(pt, map_location="cpu", weights_only=True)  # read in full
    load_s = time.perf_counter() - t0
    keys = sorted(loaded)
    del loaded
    t0 = time.perf_counter()
    convert.main([pt, os.path.join(work, "converted"), "--step", str(source["step"])] + CONFIG_ARGS)
    convert_s = time.perf_counter() - t0
    back = snapshot(CheckpointManager(os.path.join(work, "converted")).load()["train_state"])
    differ = [k for k in source if not (torch.equal(source[k], back[k])
                                        if isinstance(source[k], torch.Tensor)
                                        else source[k] == back[k])]
    if back.keys() != source.keys() or differ or source["g_opt.count"] < 1:
        raise AssertionError(f"export -> convert is not the source state: {differ[:8]}")

    # the training CLI from the .pt: one epoch of the synthetic fixture, 4
    # steps at batch 16 (cut from 24 for the soak phase's time)
    exp = os.path.join(work, "from_pt")
    zero_counts()
    run = train.main(CONFIG_ARGS + [
        "--synthetic", "--epochs", "1", "--batch_size", "16", "--seed", str(seed),
        "--device", DEVICE, "--no_validation_metrics", "--load_checkpoint", pt,
        "--experiment_path", exp], config_overrides=dict(checkpoint_every_n_epochs=1))
    train_counts = read_counts()
    state, steps = run["state"], run["steps"]
    per_step = {k: expected_launches(gcfg, dcfg, "d_step")[k]
                + expected_launches(gcfg, dcfg, "g_step")[k] for k in train_counts}
    want = {k: v * steps + grid_launches(gcfg, 1)[k] for k, v in per_step.items()}
    counts_ok = (int(state.g_opt.count) == source["g_opt.count"] + steps
                 and int(state.d_opt.count) == source["d_opt.count"] + steps)
    if not run["finite"] or train_counts != want or not counts_ok:
        raise AssertionError(f"training from the .pt: finite={run['finite']}, launches "
                             f"{train_counts} (expected {want}), Adam counts "
                             f"{int(state.g_opt.count)} / {int(state.d_opt.count)}")
    ema = {k: v.detach().cpu() for k, v in state.g_ema.state_dict().items()}
    del run, state
    empty_cache()

    # the sampling CLI on the port's own checkpoints
    out = os.path.join(work, "samples_from_models")
    zero_counts()
    srun = sample.main(CONFIG_ARGS + ["--checkpoint", os.path.join(exp, "models"),
                                      "--samples", str(BATCH), "--batch_size", str(BATCH),
                                      "--seed", str(seed), "--output", out, "--device", DEVICE])
    sample_counts = read_counts()
    loaded = sample.load_generator(os.path.join(exp, "models"), gcfg, torch.device("cpu"))
    same = all(torch.equal(v, ema[k]) for k, v in loaded.state_dict().items())
    want = {k: v * 1 for k, v in launches_per_g_forward(gcfg).items()}
    if not (srun["finite"] and same and sample_counts == want and len(os.listdir(out)) == 2 * BATCH):
        raise AssertionError(f"sampling the port's checkpoint: finite={srun['finite']}, "
                             f"EMA loaded bitwise={same}, launches {sample_counts}")
    row = {"pt_mb": os.path.getsize(pt) / 2**20, "pt_keys": keys, "export_s": export_s,
           "load_s": load_s, "convert_s": convert_s, "tensors_compared": len(source),
           "train_from_pt": {"steps": steps, "launches": train_counts,
                             "g_adam_count": source["g_opt.count"] + steps},
           "sample_from_models": {"samples": srun["samples"], "launches": sample_counts,
                                  "seconds": srun["seconds"]}}
    print("reference", json.dumps(row), flush=True)
    return {k: train_counts[k] + sample_counts[k] for k in train_counts}, pt, row


INTERP_FRAMES, INTERP_BATCH, INTERP_ANCHORS = 96, 32, 16


def gif_layout(path: str):
    """(width, height, frames) of a GIF, walking its blocks."""
    data = Path(path).read_bytes()
    if data[:6] != b"GIF89a":
        raise AssertionError(f"{path}: not a GIF89a")
    w, h = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    i = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)
    frames = 0

    def skip_blocks(i):
        while data[i]:
            i += data[i] + 1
        return i + 1

    while data[i] != 0x3B:
        if data[i] == 0x21:
            i = skip_blocks(i + 2)
        elif data[i] == 0x2C:
            frames += 1
            i = skip_blocks(i + 11)
        else:
            raise AssertionError(f"{path}: unknown block 0x{data[i]:02x} at {i}")
    return w, h, frames


def phase_interpolate(seed: int, pt: str, work: str):
    """The interpolation CLI at the flagship config from the reference .pt:
    96 frames at batch 32; the GIF's frame count and size, finite frames,
    the launches of three forwards, the upfirdn2d variant of every batch-32
    site, and two rows of the CLI's own first batch against the CPU's
    images of the latents the CLI fed them (fixed noise: each sample is
    independent of the rest of its batch)."""
    import torch

    from multi_stylegan_torch.cli import interpolate, sample

    gcfg, _ = train_configs()
    out = os.path.join(work, "interpolation")
    with BatchVariants(INTERP_BATCH) as sites:
        zero_counts()
        run = interpolate.main(CONFIG_ARGS + [
            "--checkpoint", pt, "--frames", str(INTERP_FRAMES), "--batch_size", str(INTERP_BATCH),
            "--anchors", str(INTERP_ANCHORS), "--seed", str(seed), "--output", out,
            "--device", DEVICE])
        counts = read_counts()
    forwards = -(-INTERP_FRAMES // INTERP_BATCH)
    want = {k: v * forwards for k, v in launches_per_g_forward(gcfg).items()}
    h, w = gcfg.resolution
    layout = gif_layout(run["gif"])
    if layout != (2 * w, h, INTERP_FRAMES) or not run["finite"] or counts != want:
        raise AssertionError(f"interpolation CLI: GIF {layout}, finite={run['finite']}, "
                             f"launches {counts} (expected {want})")
    sites.check("batch-32 interpolation")
    rows = [0, INTERP_BATCH - 1]
    got = torch.from_numpy(run["first_batch"][rows])
    with torch.inference_mode():
        ref = sample.load_generator(pt, gcfg, torch.device("cpu"))(
            torch.from_numpy(run["latents"][rows]), randomize_noise=False)
    peak, err = float(ref.abs().max()), float((got - ref).abs().max())
    row = {"frames": run["frames"], "seconds": run["seconds"],
           "frames_per_s": run["frames"] / run["seconds"],
           "generate_frames_per_s": run["frames"] / run["generate_seconds"],
           "gif_mb": os.path.getsize(run["gif"]) / 2**20, "gif_layout": layout,
           "launches": counts, "sites": {str(k): v for k, v in sites.seen.items()},
           "rows_compared": rows, "max_abs_err": err, "peak": peak}
    print("interpolate", json.dumps(row), flush=True)
    if not (math.isfinite(err) and err <= SAMPLE_TOL * max(1.0, peak)):
        raise AssertionError(f"interpolation batch-32 rows card vs CPU: {err}, peak {peak}")
    return counts, row


# ----------------------------------------------------------------- slice 7

DDP_WORLD = 2


def ddp_iteration(seed: int, batch: int = TRAIN_BATCH) -> dict:
    """Phase train_iteration's f32 regularised iteration (its seed-made
    state, draws and batch, of ``batch`` rows) as this process's rank: this
    data rank's rows of the global batch and of every draw, the models split
    over the model axis as the Trainer splits them, the path length through
    the Trainer's ladder.  Returns the state, every update's gradients
    (device copies, gathered whole), the metrics, each sub-step's seconds,
    launches and collectives (seconds, count, MiB), the ladder's tier, the
    launches and the peak memory, and this rank's rows of the training,
    wrong-order and path-length batches.  A new process's first iteration
    includes Triton's builds and cuDNN's choices."""
    import torch
    import torch.distributed as dist

    from multi_stylegan_torch.io.checkpoint import train_state_dict
    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.parallel import mesh
    from multi_stylegan_torch.parallel import tensor as tp
    from multi_stylegan_torch.train.draws import ShardDraws, TorchDraws
    from multi_stylegan_torch.train.robust import RobustPathLength
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import StepFlags, TrainStep

    (gcfg, dcfg), cfg = train_configs(), TrainingConfig(batch_size=batch)
    gen = random_generator(gcfg, seed + 10).train().to(DEVICE)
    disc = random_discriminator(dcfg, seed + 11).to(DEVICE)
    tp.shard_model(gen)  # as the Trainer starts
    tp.shard_model(disc)
    state = create_train_state(gen, disc, cfg)
    mesh.broadcast_state(train_state_dict(state))
    ts = TrainStep(cfg, top_k_start_iteration=0, top_k_final_iteration=2)
    draws = TorchDraws(torch.Generator(device=DEVICE).manual_seed(seed + 12))
    if mesh.world() > 1:
        draws = ShardDraws(draws)
    real = mesh.shard(real_batch(batch, gcfg.resolution, seed + 13)).to(DEVICE)
    ladder = RobustPathLength(ts)
    flags = StepFlags(wrong_order=True, do_cut_mix=True, do_ema=False)
    rows = {what: mesh.counts(n)[mesh.rank()] for what, n in (
        ("train", batch), ("wrong", ts.wrong_order_batch(batch)),
        ("path_length", ts.path_length_batch(batch)))}
    updates, seconds, reduce_s, current = [], {}, {}, [None]
    reduce_n, reduce_mib, sub_launches = {}, {}, {}

    for opt in (state.d_opt, state.g_opt):
        def step(grads, _step=opt.step, _opt=opt):
            updates.append((_opt, [None if g is None else g.detach().clone()
                                   for g in grads]))
            return _step(grads)
        opt.step = step

    def timed(name, fn):
        def run(*a, **kw):
            current[0], reduce_s[name], reduce_n[name], reduce_mib[name] = name, 0.0, 0, 0.0
            c0 = read_counts()  # synchronizes
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            seconds[name] = time.perf_counter() - t0
            c1 = read_counts()
            sub_launches[name] = {k: c1[k] - c0[k] for k in c1}
            return out
        return run

    orig_all_reduce = dist.all_reduce

    def all_reduce(tensor, *a, **kw):  # host seconds of every collective, the device idle
        sync()
        t0 = time.perf_counter()
        try:
            return orig_all_reduce(tensor, *a, **kw)
        finally:
            sync()
            reduce_s[current[0]] += time.perf_counter() - t0
            reduce_n[current[0]] += 1
            reduce_mib[current[0]] += tensor.numel() * tensor.element_size() / 2**20

    def iterate():
        metrics = ts.main_step(state, real, flags, draws)
        metrics["loss_discriminator_regularization"] = timed("r1_update", ts.r1_update)(state, real)
        pen, pl, pl_metrics = timed("path_length_update", ladder)(state, draws)
        metrics.update(loss_path_length_regularization=pen, path_length=pl, **pl_metrics)
        return {k: float(v) for k, v in metrics.items()}

    for name in ("d_step", "cut_mix_step", "g_step"):
        setattr(ts, name, timed(name, getattr(ts, name)))
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dist.all_reduce = all_reduce
    try:
        zero_counts()
        metrics = iterate()
        counts = read_counts()
        out = {"seconds": dict(seconds), "all_reduce_s": dict(reduce_s),
               "all_reduces": dict(reduce_n), "all_reduce_mib": dict(reduce_mib),
               "sub_step_launches": dict(sub_launches)}
    finally:
        dist.all_reduce = orig_all_reduce
    peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else None
    reserved = torch.cuda.max_memory_reserved() / 2**30 if DEVICE == "cuda" else None
    gathered = [[None if g is None else tp.full_tensor(g, d) for g, d in zip(u, opt.shard_dims)]
                for opt, u in updates]
    out.update(state=state, updates=gathered, metrics=metrics, tier=ladder.chunks,
               launches=counts, peak_memory_gib=peak, peak_reserved_gib=reserved, rows=rows)
    return out


def replicated_tensors(state) -> list:
    """Every tensor of the training state that each rank holds whole: all
    of them under data parallelism, all but the blocks of the sharded
    leaves (parallel/tensor.py) and their moments under tensor parallelism."""
    from multi_stylegan_torch.io.checkpoint import train_state_dict
    from multi_stylegan_torch.parallel import mesh
    from multi_stylegan_torch.parallel import tensor as tp

    sd = train_state_dict(state)
    for key, module in (("generator", state.generator), ("g_ema", state.g_ema),
                        ("discriminator", state.discriminator)):
        sharded = tp.sharded_keys(module)
        sd[key] = {k: v for k, v in sd[key].items() if k not in sharded}
    for key, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for moments in ("exp_avg", "exp_avg_sq"):
            sd[key][moments] = [m for m, d in zip(sd[key][moments], opt.shard_dims) if d is None]
    return mesh.tensors_of(sd)


def ranks_bitwise_equal(state) -> bool:
    """Every tensor each rank holds whole the same bits on every rank: rank
    0's bytes broadcast and compared."""
    import torch
    import torch.distributed as dist

    from multi_stylegan_torch.parallel import mesh

    mine = torch.cat([t.detach().reshape(-1).contiguous().view(torch.uint8)
                      for t in replicated_tensors(state)])
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)
    return not mesh.any_rank(not torch.equal(mine, theirs), mine.device)


def ddp_rank(rank: int, world: int, init_method: str, seed: int, out: str, n_model: int,
             batch: int) -> None:
    """One rank of phase ddp or tp (spawned): the iteration, the bitwise
    check; rank 0 writes the gathered gradients, every rank its summary."""
    import torch

    from multi_stylegan_torch.parallel import mesh
    from multi_stylegan_torch.utils.precision import pin_f32

    pin_f32()
    device = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device("cpu")
    backend = mesh.init(world, rank, init_method, device, shares_card=True, n_model=n_model)
    try:
        run = ddp_iteration(seed, batch=batch)
        keys = ("metrics", "seconds", "all_reduce_s", "all_reduces", "all_reduce_mib", "tier",
                "launches", "sub_step_launches", "peak_memory_gib", "peak_reserved_gib", "rows")
        summary = {k: run[k] for k in keys}
        summary.update(backend=backend, bitwise_equal=ranks_bitwise_equal(run["state"]))
        if rank == 0:
            torch.save([[None if g is None else g.cpu() for g in u] for u in run["updates"]],
                       os.path.join(out, "updates.pt"))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(summary, f)
    finally:
        mesh.shutdown()


# The spawned ranks of phases ddp, tp and ddp_uneven share the one card with
# this process.  Phase ddp_uneven's four ranks each allocate up to ~14.4 GiB
# at once; the default allocator's split blocks can take their sum over the
# card's 79 GiB in the path-length update, whose ladder then chunks it and
# the ranks no longer run the one-process iteration.  Expandable segments
# keep a rank's reserve within ~0.1 GiB of its peak (H100 80GB HBM3).
ALLOC_CONF_ENV = "PYTORCH_CUDA_ALLOC_CONF"
RANK_ALLOC_CONF = "expandable_segments:True"


def spawned_iteration(name: str, seed: int, world: int, n_model: int, batch: int,
                      counts: dict = None) -> tuple:
    """``world`` ranks on the one card (gloo) at ``n_model`` model ranks run
    phase train_iteration's f32 iteration at global batch ``batch``, held
    against the same iteration in one process (run here first and freed
    before the ranks start): every update's gathered gradient within
    GRAD_TOL of its peak, every rank's metrics within 1e-3 relative, what
    each rank holds whole the same bits on every rank, and each rank's K1-K4
    launches, sub-step by sub-step, those of the one-process iteration but
    where it holds no rows of a sub-batch (:func:`rank_launches`); the
    one-process iteration's those of phase train_iteration (``counts``,
    when given).  Per rank: its rows of each sub-batch, each sub-step's
    seconds, its collectives' seconds, count and MiB, its launches and its
    peak memory allocated and reserved; the card's free memory as the
    ranks start, which run with the allocator of ``RANK_ALLOC_CONF``."""
    import torch

    ref = ddp_iteration(seed, batch=batch)
    ref_updates = [[None if g is None else g.cpu() for g in u] for u in ref["updates"]]
    ref_row = {k: ref[k] for k in ("seconds", "tier", "launches", "sub_step_launches",
                                   "peak_memory_gib")}
    ref_metrics = ref["metrics"]
    del ref
    empty_cache()
    card_free = torch.cuda.mem_get_info()[0] / 2**30 if DEVICE == "cuda" else None
    alloc_conf = os.environ.get(ALLOC_CONF_ENV)
    with tempfile.TemporaryDirectory(prefix=f"{name}_") as out:
        t0 = time.perf_counter()
        if RANK_ALLOC_CONF:  # read by each spawned rank as its allocator starts
            os.environ[ALLOC_CONF_ENV] = RANK_ALLOC_CONF
        try:
            torch.multiprocessing.start_processes(
                ddp_rank, args=(world, f"file://{os.path.join(out, 'rendezvous')}", seed, out,
                                n_model, batch),
                nprocs=world, join=True, start_method="spawn")
        finally:
            if alloc_conf is None:
                os.environ.pop(ALLOC_CONF_ENV, None)
            else:
                os.environ[ALLOC_CONF_ENV] = alloc_conf
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        got = torch.load(os.path.join(out, "updates.pt"), mmap=True, weights_only=True)
        if len(got) != 6 or len(ref_updates) != 6:
            raise AssertionError(f"{name}: {len(got)} updates, one process {len(ref_updates)}")
        errors = []
        for k, (a, b) in enumerate(zip(got, ref_updates)):
            if [g is None for g in a] != [g is None for g in b]:
                raise AssertionError(f"{name} update {k}: other parameters got gradients")
            pairs = [(x, y) for x, y in zip(a, b) if y is not None]
            peak, err = flat_max(y for _, y in pairs), flat_max(x - y for x, y in pairs)
            errors.append({"max_abs_err": err, "peak": peak})
            if not (math.isfinite(err) and peak > 0 and err <= GRAD_TOL * peak):
                raise AssertionError(f"{name} update {k}: max abs err {err}, peak {peak}")
        del got
    metric_err = [{k: abs(rank["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in ref_metrics.items() if abs(rank["metrics"][k] - v) > 0}
                  for rank in ranks]
    row = {"world": world, "n_model": n_model, "batch": batch, "wall_s": wall,
           "card_free_gib": card_free, "rank_alloc_conf": RANK_ALLOC_CONF, "one_process": ref_row, "ranks": ranks, "update_errors": errors,
           "metric_rel_errors": metric_err}
    print(name, json.dumps(row), flush=True)
    if any(e > 1e-3 for errs in metric_err for e in errs.values()):
        raise AssertionError(f"{name} metrics off the one-process ones: {metric_err}")
    if counts not in (None, ref_row["launches"]):
        raise AssertionError(f"{name}: one process launched {ref_row['launches']}, phase "
                             f"train_iteration {counts}")
    for r, rank in enumerate(ranks):
        if not rank["bitwise_equal"] or rank["tier"] != 1:
            raise AssertionError(f"{name} rank {r}: equal={rank['bitwise_equal']}, "
                                 f"tier {rank['tier']}")
        want = rank_launches(ref_row["sub_step_launches"], rank["rows"])
        total = {k: ref_row["launches"][k] + sum(
            want[s][k] - ref_row["sub_step_launches"][s][k] for s in want) for k in KERNELS}
        if rank["sub_step_launches"] != want or rank["launches"] != total:
            raise AssertionError(f"{name} rank {r} ({rank['rows']} rows) launches "
                                 f"{rank['sub_step_launches']}, expected {want}")
    empty_cache()
    return {k: sum(rank["launches"][k] for rank in ranks) for k in KERNELS}, row


def rank_launches(one_process: dict, rows: dict) -> dict:
    """A rank's K1-K4 launches per sub-step: the one-process iteration's
    ``one_process``, but a rank that holds no wrong-order rows (``rows``)
    runs its D step's wrong-order pass on zero rows, which launch nothing,
    so that step launches what it would without wrong order."""
    want = dict(one_process)
    if not rows["wrong"]:
        want["d_step"] = expected_launches(*train_configs(), "d_step", wrong_order=False)
    return want


DDP_BATCH = 8  # cut from 24 for the soak phase's time (a launch count is batch-free)


def phase_ddp(seed: int, iteration_counts: dict) -> tuple:
    """Two data ranks at global batch ``DDP_BATCH``, half of it each
    (:func:`spawned_iteration`); their launches also phase
    train_iteration's."""
    return spawned_iteration("ddp", seed, DDP_WORLD, 1, DDP_BATCH, iteration_counts)


TP_BATCH = 4  # the global batch of phase tp: every channel gather goes through host memory


def phase_tp(seed: int) -> tuple:
    """A (data 1, model 2) mesh on the one card (gloo): the two ranks split
    every sharded conv weight's output channels (parallel/tensor.py) and run
    the f32 regularised iteration at the published widths and global batch
    ``TP_BATCH`` (:func:`spawned_iteration`)."""
    return spawned_iteration("tp", seed, 2, 2, TP_BATCH)


UNEVEN_WORLD, UNEVEN_BATCH = 4, 12  # the reference batch 24 over 8 ranks, at half of both


def phase_ddp_uneven(seed: int) -> tuple:
    """Four data ranks on the one card (gloo) at the published widths and
    global batch 12 (:func:`spawned_iteration`): 3 training rows a rank,
    the wrong-order rows [1, 1, 1, 0] and the path-length rows [2, 2, 1, 1],
    as the reference batch 24 falls over 8 ranks.  Rank 3's D step runs
    its wrong-order pass on zero rows."""
    counts, row = spawned_iteration("ddp_uneven", seed, UNEVEN_WORLD, 1, UNEVEN_BATCH)
    layout = {k: [r["rows"][k] for r in row["ranks"]] for k in ("train", "wrong", "path_length")}
    if layout != {"train": [3, 3, 3, 3], "wrong": [1, 1, 1, 0], "path_length": [2, 2, 1, 1]}:
        raise AssertionError(f"ddp_uneven: the rows fell as {layout}")
    return counts, row


COUNTS_DIR_ENV = "CHIP_SMOKE_COUNTS_DIR"


def counted_spawned_rank(device, args, config_overrides, validation_samples):
    """A rank the training CLI spawned (``cli/train.py::_spawned_rank``,
    through ``parallel/mesh.py::spawn``), and into the directory
    ``COUNTS_DIR_ENV`` names this rank's K1-K4 launches, whether each
    checkpoint it restored came back bit for bit (its training state and the
    draws' state), and a digest of its final state (phase ddp_cli puts it in
    the CLI's place)."""
    import hashlib

    import torch

    from multi_stylegan_torch.cli import train
    from multi_stylegan_torch.io.checkpoint import train_state_dict
    from multi_stylegan_torch.parallel import mesh
    from multi_stylegan_torch.train.loop import Trainer

    restored, load = [], Trainer.load_payload

    def load_payload(self, saved):
        load(self, saved)
        mine = mesh.tensors_of(train_state_dict(self.state))
        theirs = mesh.tensors_of(saved["train_state"])
        restored.append(len(mine) == len(theirs)
                        and all(torch.equal(a.cpu(), b) for a, b in zip(mine, theirs))
                        and torch.equal(self.draws.generator.get_state(), saved["draws"]))
    Trainer.load_payload = load_payload
    zero_counts()
    run = train.train(args, device, config_overrides, validation_samples)
    counts = read_counts()
    digest = hashlib.sha256()
    for t in mesh.tensors_of(train_state_dict(run["state"])):
        digest.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    with open(os.path.join(os.environ[COUNTS_DIR_ENV], f"rank{mesh.process_index()}.json"),
              "w") as f:
        json.dump({"launches": counts, "restored_bitwise": restored,
                   "state_sha256": digest.hexdigest()}, f)
    return train.summary(run)


def run_to_file(log: str, fn, *a, **kw):
    """``fn(*a, **kw)`` with file descriptor 1 (spawned ranks' too) in ``log``."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(log, "w") as f:
            os.dup2(f.fileno(), 1)
            return fn(*a, **kw)
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def phase_ddp_cli(seed: int) -> tuple:
    """``cli.train --devices 2`` at the tiny config on the card (two ranks
    sharing it over gloo; ``--resume_training`` turns wrong order and
    cut-mix on): 2 epochs of 4 steps with one checkpoint at the end, then a
    resume from it for 1 epoch on 2 ranks.  One writer (each step reported
    once, the one checkpoint and nothing else), every rank's restored state
    the checkpoint's bits, the ranks replicas at the end of each run (one
    state digest), every kernel launched on every rank.  (Two runs of the
    same steps on the card are not bitwise one another: the ADA warp's
    adjoint adds with atomics.)"""
    import shutil

    from multi_stylegan_torch.cli import train

    tmp = tempfile.mkdtemp(prefix="ddp_cli_")
    base = ["--tiny", "--synthetic", "--device", DEVICE, "--devices", str(DDP_WORLD),
            "--batch_size", "16", "--seed", str(seed), "--resume_training",
            "--no_validation_metrics"]
    runs, ranks = {}, {}
    orig, train._spawned_rank = train._spawned_rank, counted_spawned_rank
    try:
        for name, argv, epochs in (("first", [], 2), ("resumed", [
                "--load_checkpoint", os.path.join(tmp, "first", "models")], 1)):
            counts_dir = os.environ[COUNTS_DIR_ENV] = os.path.join(tmp, f"{name}_counts")
            os.makedirs(counts_dir)
            t0 = time.perf_counter()
            runs[name] = run_to_file(os.path.join(tmp, f"{name}.log"), train.main, base + argv + [
                "--epochs", str(epochs), "--experiment_path", os.path.join(tmp, name)],
                config_overrides={"checkpoint_every_n_epochs": 2})
            runs[name]["wall_s"] = time.perf_counter() - t0
            ranks[name] = []
            for r in range(DDP_WORLD):
                with open(os.path.join(counts_dir, f"rank{r}.json")) as f:
                    ranks[name].append(json.load(f))
        with open(os.path.join(tmp, "first.log")) as f:
            log = f.read()
        models = sorted(os.listdir(os.path.join(tmp, "first", "models")))
    finally:
        train._spawned_rank = orig
        os.environ.pop(COUNTS_DIR_ENV, None)
        shutil.rmtree(tmp, ignore_errors=True)
    first, resumed = runs["first"], runs["resumed"]
    row = {"first_s": first["wall_s"], "resumed_s": resumed["wall_s"],
           "step_s": [m["seconds"] for m in first["history"] + resumed["history"]],
           "models": models, "ranks": ranks}
    print("ddp cli", json.dumps(row), flush=True)
    reports = [log.count(f"step {s}:") for s in range(1, 9)]
    if (first["steps"] != 8 or resumed["steps"] != 4 or not first["finite"]
            or not resumed["finite"] or reports != [1] * 8 or log.count("Start training") != 1
            or models != ["checkpoint_8.pt"]):
        raise AssertionError(f"ddp cli: steps {first['steps']}/{resumed['steps']}, reports "
                             f"{reports}, models {models}")
    for name, rs in ranks.items():
        want_restored = [True] if name == "resumed" else []
        if (any(r["restored_bitwise"] != want_restored for r in rs)
                or len({r["state_sha256"] for r in rs}) != 1
                or not all(all(r["launches"].values()) for r in rs)):
            raise AssertionError(f"ddp cli {name} run's ranks: {rs}")
    return {k: sum(r["launches"][k] for rs in ranks.values() for r in rs) for k in KERNELS}, row


def phase_teacher(seed: int, work: str) -> tuple:
    """``tools/stability_run.py`` at the flagship config, bf16, batch 8,
    on the teacher fixture, for 17 steps through ``Trainer.train`` (the lazy
    R1 and path length inside the loop at step 16), checkpointed at step 8
    and restored into other weights: every metric finite, the steps'
    seconds."""
    from multi_stylegan_torch.tools import stability_run

    zero_counts()
    report = stability_run.main(CONFIG_ARGS + [
        "--steps", "17", "--batch", "8", "--dtype", "bfloat16", "--fixture", "teacher",
        "--device", DEVICE, "--seed", str(seed), "--out", os.path.join(work, "teacher.json")])
    counts = read_counts()
    row = {k: report[k] for k in ("ok", "final_step", "regularised_steps", "step_seconds",
                                  "wall_s", "seqs_per_sec", "ada_p_range", "nan_steps", "events")}
    row["launches"] = counts
    print("teacher", json.dumps(row), flush=True)
    if not report["ok"] or report["final_step"] != 17 or report["regularised_steps"] != [16]:
        raise AssertionError(f"teacher run: {row}")
    if not all(counts.values()):
        raise AssertionError(f"teacher run: a kernel was never launched: {counts}")
    empty_cache()
    return counts, row


SOAK_ARGS = ["--epochs", "2", "--steps_per_epoch", "8", "--batch", str(TRAIN_BATCH),
             "--dtype", "bfloat16", "--val_samples", "48", "--val_batch", "8"]


def phase_soak(work: str) -> tuple:
    """``tools/soak_b24.py`` at the flagship config, bf16, batch 24, on the
    teacher fixture, its two phases in this process on one data rank
    (``--devices 1``, whatever cards the machine shows; the counts zeroed
    before each): phase A 8 steps, a checkpoint at epoch 1 and a validation
    pass (48 samples); phase B restores step 8 under ``resume_training``
    from the shared checkpoint directory and runs 8 steps (R1 and path
    length at step 16).  Phase B's own validation pass, the same code on
    other weights, is left to the tool's long run: a FID pass spends 25-57 s
    in scipy's host ``sqrtm`` here.  Fails unless the record is ``ok``, the
    restored step 8 and the final 16, phase A ran FID, FVD and IS and none
    failed, R1 and path length ran at step 16 and phase B launched every
    kernel, the dx-only K2 among them."""
    import numpy as np

    from multi_stylegan_torch.ops import fused_act
    from multi_stylegan_torch.tools import soak_b24

    workdir = os.path.join(work, "soak")
    argv = CONFIG_ARGS + SOAK_ARGS + ["--device", DEVICE, "--devices", "1", "--workdir",
                                      workdir, "--out", os.path.join(work, "soak.json")]
    counts, dx_only, seconds = {}, {}, {}
    config = soak_b24.phase_config
    for phase in ("a", "b"):
        if phase == "b":  # no epoch of phase B's is a validation epoch
            soak_b24.phase_config = lambda args, resume, epochs: dataclasses.replace(
                config(args, resume, epochs), validate_every_n_epochs=epochs + 1)
        zero_counts()
        t0 = time.perf_counter()
        try:
            report = soak_b24.main(argv + ["--phase", phase])
        finally:
            soak_b24.phase_config = config
        sync()
        seconds[phase] = time.perf_counter() - t0
        counts[phase], dx_only[phase] = read_counts(), fused_act.grad_dx_only_launches
        empty_cache()
    metrics = os.path.join(workdir, "phase_b", "metrics")
    regs = {name: np.load(os.path.join(metrics, f"{name}.npy")).tolist()
            for name in ("loss_discriminator_regularization", "path_length")}
    row = {"ok": report["ok"], "restored_step": report.get("restored_step"),
           "final_step": report.get("final_step"), "seconds": seconds,
           "launches": counts, "dx_only_launches": dx_only, "phase_b_regularisers": regs,
           "events": [e for e in report["events"] if e["event"] != "warning"]}
    for tag in ("phase_a", "phase_b"):
        row[tag] = {k: report[tag][k] for k in ("steps", "wall_s", "seqs_per_sec",
                                                "peak_memory_bytes")}
        row[tag]["peak_gib"] = (report[tag]["peak_memory_bytes"] or 0) / 2 ** 30
    row["validation_wall_s"] = [(e["event"], e["wall_s"]) for e in report["events"]
                                if e["event"].startswith("validation") and "wall_s" in e]
    print("soak", json.dumps(row), flush=True)
    failed = [e for e in report["events"] if "FAILED" in e["event"]]
    validated = [e["event"] for e in report["events"] if e["event"].startswith("validation")]
    reg_steps = [i + 9 for i, (r1, pl) in enumerate(zip(*regs.values())) if r1 > 0 and pl > 0]
    if (not report["ok"] or report["restored_step"] != 8 or report["final_step"] != 16
            or failed or reg_steps != [16]
            or validated != ["validation FID", "validation FVD", "validation IS"]):
        raise AssertionError(f"soak: {row}")
    if not all(counts["b"].values()) or not dx_only["b"]:
        raise AssertionError(f"soak: phase B never launched a kernel: {counts['b']}, "
                             f"dx-only K2 {dx_only['b']}")
    return {k: counts["a"][k] + counts["b"][k] for k in KERNELS}, row


def frechet_rows(calls: list) -> list:
    """The device Frechet distance (``eval/frechet.py::frechet_distance_device``)
    on the activations of each host one the validation computed, with both
    values, both times and the gap; then its time on full-rank activations
    at the protocol's 5000 samples of 2048 dims (no host value there)."""
    import torch

    from multi_stylegan_torch.eval.frechet import frechet_distance_device

    def device_ms(real, fake):
        out = frechet_distance_device(real, fake)  # the first call sets cuBLAS up
        sync()
        t0 = time.perf_counter()
        out = frechet_distance_device(real, fake)
        return out, (time.perf_counter() - t0) * 1e3

    rows = []
    for real, fake, host, host_s in calls:
        dev, ms = device_ms(torch.from_numpy(real).to(DEVICE), torch.from_numpy(fake).to(DEVICE))
        rows.append({"samples": real.shape[0], "dims": real.shape[1], "host": host,
                     "host_s": host_s, "device": dev, "device_ms": ms,
                     "rel_gap": abs(dev - host) / abs(host) if host else None})
    g = torch.Generator(device=DEVICE).manual_seed(7)
    mix = torch.eye(2048, device=DEVICE) + torch.randn(2048, 2048, generator=g, device=DEVICE) / 64
    real = torch.randn(PROTOCOL_SAMPLES, 2048, generator=g, device=DEVICE) @ mix
    fake = (torch.randn(PROTOCOL_SAMPLES, 2048, generator=g, device=DEVICE) + 0.1) @ mix
    value, ms = device_ms(real, fake)
    rows.append({"samples": PROTOCOL_SAMPLES, "dims": 2048, "device": value, "device_ms": ms})
    return rows


# --------------------------------------------------------------------- main


KERNELS = {
    "K1": ("fused_leaky_relu", "triton", "multi_stylegan_torch/ops/fused_act.py",
           "multi_stylegan_tpu/ops/pallas_kernels.py:97"),
    "K2": ("fused_leaky_relu_grad", "cuda", "multi_stylegan_torch/csrc/fused_act.cu",
           "multi_stylegan_tpu/ops/pallas_kernels.py:106"),
    "K3": ("upfirdn2d", "cuda", "multi_stylegan_torch/csrc/upfirdn2d.cu",
           "multi_stylegan_tpu/ops/pallas_kernels.py:209"),
    "K4": ("upfirdn2d_grad", "cuda", "multi_stylegan_torch/csrc/upfirdn2d.cu",
           "multi_stylegan_tpu/ops/pallas_kernels.py:337"),
}


def kernel_line(train_rows: dict, sample_report: dict, launches: dict) -> dict:
    """Per kernel: launches over the main-path runs; times, bound and errors
    per regularised training iteration (site time x its launches, summed)."""
    planar = sample_report["planar"]
    sample_rows = {"K1": sample_report["fused_leaky_relu"] + [r for r in planar if "up" not in r],
                   "K3": sample_report["upfirdn2d"] + [r for r in planar if "up" in r]}
    out = []
    for k, (name, route, source, replaces) in KERNELS.items():
        rows = train_rows[k]

        def per_iteration(key):
            vals = [r[key] for r in rows if r["launches_per_iteration"]]
            if any(v is None for v in vals):
                return None
            return sum(r[key] * r["launches_per_iteration"] for r in rows
                       if r["launches_per_iteration"])

        t_bytes = sum(r["bound_ms"] * r["launches_per_iteration"] for r in rows
                      if r["bound_by"] == "bytes")
        errs = [r["max_abs_err_float32"] for r in rows + sample_rows.get(k, [])]
        out.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": max(errs),
            "ms": per_iteration("ms"), "plain_ms": per_iteration("plain_ms"),
            "bound_ms": per_iteration("bound_ms"),
            "bound_by": "bytes" if t_bytes >= 0.5 * per_iteration("bound_ms") else "operations",
            "library_ms": per_iteration("library_ms"),
        })
    return {"kernels": out}


def bf16_iteration_kernels(train_rows: dict) -> dict:
    """Per kernel, the bf16 regularised iteration: site ms x launches (its
    D, cut-mix and G steps' bf16 sites at the bf16 times, R1's and path
    length's f32 sites at the f32 times), and the bound in those bytes."""
    out = {}
    for k, rows in train_rows.items():
        def total(ms_key, bf16_key):
            return sum(r["launches_bf16_iteration_bf16"] * r[bf16_key]
                       + r["launches_bf16_iteration_f32"] * r[ms_key] for r in rows)
        out[k] = {"ms": total("ms", "ms_bf16"), "bound_ms": total("bound_ms", "bound_ms_bf16"),
                  "launches": sum(r["launches_bf16_iteration_bf16"]
                                  + r["launches_bf16_iteration_f32"] for r in rows)}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="", help="also write every result to this JSON file")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one batch-16 forward with torch.profiler")
    args = parser.parse_args()

    if not (REPO / "multi_stylegan_torch" / "__init__.py").is_file():
        fail(f"the port (multi_stylegan_torch/) is not beside {__file__}")
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: the port's kernels run only on the GPU")
    sys.path.insert(0, str(REPO))
    from multi_stylegan_torch.ops import cuda_build
    from multi_stylegan_torch.utils.precision import pin_f32

    pin_f32()  # TF32 off, as the CLIs run: the parity phases hold f32 to f32

    t_start = t0 = time.perf_counter()
    libs = cuda_build.build_all()
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    seconds = {"build": time.perf_counter() - t0}

    def phase(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        report = phase("kernels", phase_kernels, args.seed)
        counts, slice_row, forward_inputs = phase("sample", phase_slice, args.seed, report)
        if args.profile:
            slice_row["profile"] = phase_profile(*forward_inputs)
        del forward_inputs
        cli_counts, cli_row = phase("train_cli", phase_train_cli, args.seed)
        iter_counts, census, iter_row = phase("train_iteration", phase_train_iteration, args.seed)
        trained = os.path.join(work, "trained")
        bf16_counts, census_bf16, bf16_row = phase(
            "bf16_iteration", phase_train_iteration, args.seed, "bfloat16", save_to=trained)
        bf16_row["parity"] = phase("bf16_parity", phase_bf16_parity, args.seed)
        optim_row = phase("optim", phase_optim, args.seed)
        train_rows, k2_edge_row = phase("grads", phase_grad_sites, args.seed, census, census_bf16)
        parity_row = phase("parity", phase_train_parity, args.seed)
        seq_counts, seq_row = phase("sequential_fft", phase_sequential_fft, args.seed)
        pl_counts, pl_row = phase("pl_chunked", phase_pl_chunked, args.seed)
        run_counts, run_row = phase("train_run", phase_train_run, args.seed,
                                    iter_row["top_device_ops"])
        ref_counts, pt, ref_row = phase("reference", phase_reference, args.seed, trained, work)
        interp_counts, interp_row = phase("interpolate", phase_interpolate, args.seed, pt, work)
        ddp_counts, ddp_row = phase("ddp", phase_ddp, args.seed, iter_counts)
        tp_counts, tp_row = phase("tp", phase_tp, args.seed)
        uneven_counts, uneven_row = phase("ddp_uneven", phase_ddp_uneven, args.seed)
        ddp_cli_counts, ddp_cli_row = phase("ddp_cli", phase_ddp_cli, args.seed)
        teacher_counts, teacher_row = phase("teacher", phase_teacher, args.seed, work)
        soak_counts, soak_row = phase("soak", phase_soak, work)

    sample_counts = {"K1": counts["fused_leaky_relu"], "K2": 0,
                     "K3": counts["upfirdn2d"], "K4": 0}
    by_path = {"sample_cli": sample_counts, "train_cli": cli_counts,
               "train_iteration": iter_counts, "bf16_iteration": bf16_counts,
               "sequential_fft": seq_counts, "pl_ladder": pl_counts, "train_run": run_counts,
               "reference": ref_counts, "interpolate": interp_counts, "ddp": ddp_counts,
               "tp": tp_counts, "ddp_uneven": uneven_counts, "ddp_cli": ddp_cli_counts,
               "teacher": teacher_counts, "soak": soak_counts}
    launches = {k: sum(c[k] for c in by_path.values()) for k in KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = kernel_line(train_rows, report, launches)
    line["kernels"] += optim_kernel_rows(
        optim_row, [iter_row["optimizer_launches"], bf16_row["optimizer_launches"]])
    bf16_kernels = bf16_iteration_kernels(train_rows)
    print("bf16 iteration kernels", json.dumps(bf16_kernels))
    seconds["total"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "sampling_sites": report, "slice": slice_row,
             "train_cli": cli_row, "train_iteration": iter_row, "bf16_iteration": bf16_row,
             "optim": optim_row,
             "bf16_iteration_kernels": bf16_kernels, "train_sites": train_rows,
             "k2_edge": k2_edge_row,
             "train_parity": parity_row, "sequential_fft": seq_row, "pl_chunked": pl_row,
             "train_run": run_row, "reference": ref_row, "interpolate": interp_row,
             "ddp": ddp_row, "tp": tp_row, "ddp_uneven": uneven_row, "ddp_cli": ddp_cli_row,
             "teacher": teacher_row, "soak": soak_row,
             "launches_by_path": by_path, "seconds": seconds, **line}, indent=1))
    print("seconds", json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
