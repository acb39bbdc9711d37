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
              sampling path at batch 16, with times; K3 and its adjoint
              (K4) at edge cases aimed at each of upfirdn2d's variants.
3. sample   - the sampling CLI (``multi_stylegan_torch.cli.sample``, full
              256x256 generator, 32 samples at batch 16, random weights)
              with the launch counts zeroed just before: PNGs, finiteness,
              34 K1 / 24 K3 launches per forward; one sample against the
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
              structure.  A census of the iteration's launches by call site
              feeds phase 5.  The same iteration runs once more under
              torch.profiler for its top device ops.
5. grads    - at every K1 / K3 call site the iteration launched (batch 24,
              12 and 6): K1 and K3 forward, K2 (dx and db) and K4 (backward
              and double backward) against the plain versions' autograd on
              the card, in f32 and bf16; kernel, plain and library times and
              the bound, in f32.  Every K3/K4 site but the C = 3 skip
              upsamples must take a tiled upfirdn2d variant.
6. parity   - GPU vs CPU (plain versions, TF32 off): a D-step gradient, the
              R1 penalty's parameter gradient and the path-length gradient
              at full width, batch 2, same weights and draws.
7. train_run - the training CLI's whole run at the flagship config: a TLFM
              tree of 16-bit TIFFs written here (48 sequences), trap weights,
              4 epochs (8 steps; trap weights from epoch 1, wrong order from
              epoch 3), the sample grids and a checkpoint every epoch, FID /
              FVD / IS every other epoch (48 samples, random-weight nets
              read from files through
              ``MSG_TPU_INCEPTION_PT`` / ``MSG_TPU_I3D_PT``) every epoch, a
              torch.profiler trace of steps 2-5; then a resume for one more
              epoch (steps 9-10) from the checkpoint.  Fails on a non-finite
              loss or score, a failed save, a missing PNG / metric file, a
              restored state not bitwise the saved one, a batch-15 grid site
              on upfirdn2d's general form (C = 3 aside), or two grid samples
              off the CPU's by more than ``SAMPLE_TOL``.

Prints one ``site`` line per call site (K3/K4 lines name the ``variant``
of upfirdn2d the launch took), one ``edge`` line per upfirdn2d edge case,
one ``train_run`` line (loader, step, grid, checkpoint and metric seconds,
checkpoint MB, peak memory, the top 15 device ops), the card's name and
power limit,
one ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.
In the kernels line ``launches`` sums the four main-path runs (sampling
CLI, training CLI, regularised iteration, training run with its resume),
each counted from zero, and
``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are per regularised
training iteration at batch 24: each training call site's time per launch
times its launches in that iteration, summed.
"""

from __future__ import annotations

import argparse
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


def cuda_ms(fn, min_total_ms: float = 30.0) -> float:
    """Mean device time of ``fn`` in ms over a run of launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(50, max(3, min_total_ms / once)))
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
    return report


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
        fused_act.launches = 0
        up_mod.launches = 0
        run = sample.main(["--checkpoint", ckpt, "--samples", str(SAMPLES),
                           "--batch_size", str(BATCH), "--seed", str(seed),
                           "--output", out_dir, "--device", "cuda"])
        torch.cuda.synchronize()
        counts = {"fused_leaky_relu": fused_act.launches, "upfirdn2d": up_mod.launches}
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
    print("slice cli", json.dumps({**run, "launches": counts,
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
    kernel_ms = {k: sum(r["ms"] * r["launches_per_forward"] for r in report[k])
                 for k in ("fused_leaky_relu", "upfirdn2d")}
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


def train_configs():
    """(generator, discriminator) configs of the training phases: the flagship."""
    from multi_stylegan_torch.models.config import DiscriminatorConfig, GeneratorConfig

    return GeneratorConfig(), DiscriminatorConfig(no_rfp=True)


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

    fused_act.launches = fused_act.grad_launches = 0
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
    """
    s = model_sites(gcfg, dcfg)
    dk1, dk3, rd = s["d_k1"], s["d_k3"], s["d_remat_k1"]
    gk1, gk3, rg1, rg3 = s["g_k1"], s["g_k3"], s["g_remat_k1"], s["g_remat_k3"]
    nd = 3 if wrong_order else 2
    table = {
        "d_step": dict(K1=gk1 + nd * (dk1 + rd), K2=nd * dk1, K3=gk3 + nd * dk3, K4=nd * dk3),
        "cut_mix_step": dict(K1=2 * (dk1 + rd), K2=2 * (dk1 - 1), K3=2 * dk3, K4=2 * dk3),
        "g_step": dict(K1=gk1 + rg1 + dk1 + rd, K2=gk1 + dk1, K3=gk3 + rg3 + dk3, K4=gk3 + dk3),
        "r1_update": dict(K1=dk1 + 2 * rd, K2=3 * dk1, K3=dk3, K4=3 * dk3),
        "path_length_update": dict(K1=gk1 + 2 * rg1, K2=2 * s["g_styled"] + gk1,
                                   K3=gk3 + 2 * rg3, K4=gk3 + 2 * s["g_blur"]),
    }
    return table[sub_step]


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

        def k2(g, *a):
            self.sites[("K2", tuple(g.shape), str(g.dtype))] += 1
            return f2(g, *a)

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


def phase_train_iteration(seed: int):
    """One regularised iteration at the flagship config, batch 24."""
    import torch

    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import StepFlags, TrainStep

    (gcfg, dcfg), cfg = train_configs(), TrainingConfig()
    gen = random_generator(gcfg, seed + 10).train().to(DEVICE)
    disc = random_discriminator(dcfg, seed + 11).to(DEVICE)
    state = create_train_state(gen, disc, cfg)
    ts = TrainStep(cfg, top_k_start_iteration=0, top_k_final_iteration=2)
    draws = TorchDraws(torch.Generator(device=DEVICE).manual_seed(seed + 12))
    real = real_batch(TRAIN_BATCH, gcfg.resolution, seed + 13).to(DEVICE)
    before = {n: p.detach().clone() for n, p in
              list(gen.named_parameters(prefix="g")) + list(disc.named_parameters(prefix="d"))}
    ema_before = [p.clone() for p in state.g_ema.parameters()]

    timings, per_sub = {}, {}

    def timed(name, fn):
        def run(*a, **kw):
            sync()
            c0, t0 = read_counts(), time.perf_counter()
            out = fn(*a, **kw)
            c1 = read_counts()  # synchronizes
            timings[name] = (time.perf_counter() - t0) * 1e3
            per_sub[name] = {k: c1[k] - c0[k] for k in c1}
            return out
        return run

    for name in ("d_step", "cut_mix_step", "g_step"):
        setattr(ts, name, timed(name, getattr(ts, name)))
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    flags = StepFlags(wrong_order=True, do_cut_mix=True, do_ema=False)
    zero_counts()
    with Census() as census:
        metrics = timed("main_step", ts.main_step)(state, real, flags, draws)
        r1 = timed("r1_update", ts.r1_update)(state, real)
        pen, pl = timed("path_length_update", ts.path_length_update)(state, draws)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else None
    metrics.update(loss_discriminator_regularization=r1, loss_path_length_regularization=pen,
                   path_length=pl)
    host = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in host.items() if not math.isfinite(v)]
    if bad or not all_finite(gen) or not all_finite(disc) or not all_finite(state.g_ema):
        raise AssertionError(f"regularised iteration: non-finite {bad or 'parameters'}")
    after = dict(list(gen.named_parameters(prefix="g")) + list(disc.named_parameters(prefix="d")))
    unmoved = [n for n, p in after.items() if torch.equal(p.detach(), before[n])]
    # a G parameter the path-length step leaves alone may sit still only if
    # the G step moved it; every D parameter moves in the D steps
    if unmoved:
        raise AssertionError(f"parameters did not move: {unmoved[:8]}")
    if all(torch.equal(a, b) for a, b in zip(ema_before, state.g_ema.parameters())):
        raise AssertionError("the EMA did not move")
    for name in ("d_step", "cut_mix_step", "g_step", "r1_update", "path_length_update"):
        want = expected_launches(gcfg, dcfg, name, wrong_order=(name == "d_step"))
        if per_sub[name] != want:
            raise AssertionError(f"{name}: launches {per_sub[name]}, expected {want}")
    # the same iteration once more under torch.profiler (the trainer's
    # profiling utility), apart from the timed one above
    from multi_stylegan_torch.utils.profiling import trace

    with tempfile.TemporaryDirectory() as tmp, trace(tmp) as tr:
        ts.main_step(state, real, flags, draws)
        ts.r1_update(state, real)
        ts.path_length_update(state, draws)
        sync()
    row = {"ms": timings, "launches": counts, "launches_by_sub_step": per_sub,
           "peak_memory_gib": peak, "metrics": host, "ada_p": float(state.ada.p),
           "top_device_ops": tr.top_device_ops(15)}
    print("slice train", json.dumps(row), flush=True)
    del state, gen, disc
    empty_cache()
    return counts, census.sites, row


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


def phase_grad_sites(seed: int, census) -> dict:
    """Every K1 and K3 call site of the regularised iteration, with its K2 /
    K4 gradients: correctness in f32 and bf16, times in f32."""
    import torch

    from multi_stylegan_torch.ops import fused_act, upfirdn2d as up_mod

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = {"K1": [], "K2": [], "K3": [], "K4": []}

    def emit(kernel, row):
        rows[kernel].append(row)
        print("site", json.dumps({"kernel": kernel, **row}), flush=True)

    for key in sorted(k for k in census if k[0] == "K1"):
        shape = key[1]
        c, m = shape[-1], math.prod(shape[:-1])
        fwd = {"shape": list(shape), "launches_per_iteration": census[key]}
        bwd = {"shape": list(shape), "launches_per_iteration": census.get(("K2",) + key[1:], 0)}
        bias = torch.randn(c, generator=g, device=dev)
        for name, dt in dtypes.items():
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
            if name == "float32":
                fwd["ms"] = cuda_ms(lambda: fused_act.fused_leaky_relu(x, bias, 0.2, 1.0))
                fwd["plain_ms"] = cuda_ms(lambda: fused_act.fused_leaky_relu_ref(x, bias, 0.2, 1.0))
                fwd["library_ms"] = None
                fwd["bound_ms"], fwd["bound_by"] = bound_ms(2 * m * c * 4 + c * 4, 4 * m * c)
                bwd["ms"] = cuda_ms(lambda: fused_act.FusedLeakyReLUBackward.apply(gy, out, 0.2, 1.0))
                bwd["plain_ms"] = cuda_ms(lambda: fused_act.fused_leaky_relu_grad_ref(gy, out, 0.2, 1.0))
                bwd["library_ms"] = None
                bwd["bound_ms"], bwd["bound_by"] = bound_ms(3 * m * c * 4 + c * 4, 4 * m * c)
            del x, gy, out, dx, db, rdx, rdb
        emit("K1", fwd)
        emit("K2", bwd)

    for key in sorted(k for k in census if k[0] == "K3"):
        _, shape, _, up, down, pad, ksize = key
        b, h, w, c = shape
        taps = torch.randn(ksize, generator=g, device=dev)
        pad_xy = (pad[2], pad[3], pad[0], pad[1])
        ho = up_mod.out_size(h, up, down, pad[0], pad[1], ksize[0])
        wo = up_mod.out_size(w, up, down, pad[2], pad[3], ksize[1])
        gpad = up_mod._adjoint_pads(ksize, up, down, pad, (h, w), (ho, wo))
        out_shape = (b, ho, wo, c)
        common = {"shape": list(shape), "up": up, "down": down, "pad": list(pad)}
        fwd = dict(common, launches_per_iteration=census[key])
        bwd = dict(common, part="backward", launches_per_iteration=census.get(
            ("K4", out_shape, key[2], down, up, gpad, ksize), 0))
        dbl = dict(common, part="double backward", launches_per_iteration=census.get(
            ("K4", shape, key[2], up, down, pad, ksize), 0))
        for name, dt in dtypes.items():
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
            if name == "float32":
                flip = taps.flip(0, 1).contiguous()
                gpad_xy = (gpad[2], gpad[3], gpad[0], gpad[1])
                used_f = (upfirdn_taps_used(h, ho, up, down, pad[0], ksize[0])
                          * upfirdn_taps_used(w, wo, up, down, pad[2], ksize[1]))
                used_b = (upfirdn_taps_used(ho, h, down, up, gpad[0], ksize[0])
                          * upfirdn_taps_used(wo, w, down, up, gpad[2], ksize[1]))
                sym = pad[0] == pad[2] and pad[1] == pad[3]
                lib_f = library_upfirdn(x, taps, up, (pad[0], pad[1])) if sym else None
                for row, fn, plain, lib, used, n_in, n_out in (
                        (fwd, lambda: up_mod.upfirdn2d(x, taps, up, down, pad_xy),
                         lambda: up_mod.upfirdn2d_ref(x, taps, up, down, pad_xy),
                         lib_f, used_f, x.numel(), y.numel()),
                        (bwd, lambda: up_mod.UpFirDn2dBackward.apply(
                            gy, taps, up, down, pad, (h, w), (ho, wo)),
                         lambda: up_mod.upfirdn2d_ref(gy, flip, down, up, gpad_xy),
                         library_conv_backward(shape, taps, up, down, pad, gy),
                         used_b, gy.numel(), x.numel()),
                        (dbl, lambda: up_mod.UpFirDn2d.apply(gg, taps, up, down, pad, True),
                         lambda: up_mod.upfirdn2d_ref(gg, taps, up, down, pad_xy),
                         library_upfirdn(gg, taps, up, (pad[0], pad[1])) if sym else None,
                         used_f, x.numel(), y.numel())):
                    row["ms"] = cuda_ms(fn)
                    row["variant"] = up_mod.last_variant
                    row["plain_ms"] = cuda_ms(plain)
                    row["library_ms"] = cuda_ms(lib) if lib is not None else None
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        (n_in + n_out) * 4 + taps.numel() * 4, 2 * used * b * c)
            del x, gy, gg, y, gx, rgx, ggy, rggy, xr, gr
        # every model site but the C = 3 skip upsamples has a tiled form
        if c != 3 and "general" in (fwd["variant"], bwd["variant"], dbl["variant"]):
            raise AssertionError(f"K3/K4 site {key} took the general variant")
        emit("K3", fwd)
        emit("K4", bwd)
        emit("K4", dbl)
    empty_cache()
    counted = {k: sum(r["launches_per_iteration"] for r in rows[k]) for k in rows}
    census_total = {k: sum(v for key, v in census.items() if key[0] == k) for k in rows}
    if counted != census_total:
        raise AssertionError(f"site rows cover {counted} launches, the census {census_total}")
    return rows


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


def phase_train_parity(seed: int) -> dict:
    """GPU vs CPU gradients at full width, batch 2, same weights and draws."""
    import dataclasses

    import torch

    from multi_stylegan_torch.models.config import TrainingConfig
    from multi_stylegan_torch.models.discriminator import Discriminator
    from multi_stylegan_torch.models.generator import Generator
    from multi_stylegan_torch.train import losses
    from multi_stylegan_torch.train.draws import TorchDraws
    from multi_stylegan_torch.train.state import create_train_state
    from multi_stylegan_torch.train.steps import TrainStep

    gcfg, dcfg = train_configs()
    cfg = TrainingConfig(batch_size=2)
    ts = TrainStep(cfg)
    cpu_g, cpu_d = random_generator(gcfg, seed + 30).train(), random_discriminator(dcfg, seed + 31)
    # the CPU side recomputes nothing (remat changes no value, only time)
    plain_g = Generator(dataclasses.replace(gcfg, remat=False))
    plain_g.load_state_dict(cpu_g.state_dict())
    plain_d = Discriminator(dataclasses.replace(dcfg, remat=False))
    plain_d.load_state_dict(cpu_d.state_dict())
    real = real_batch(2, gcfg.resolution, seed + 32)

    def grads(state, real, draws):
        d_params, g_params = list(state.discriminator.parameters()), list(state.generator.parameters())
        out = {}
        losses_ = ts.d_losses(state, real, True, draws)[0]
        out["d_step"] = torch.autograd.grad(sum(losses_.values()), d_params)
        out["r1"] = torch.autograd.grad(losses.r1_penalty(state.discriminator, real), d_params)
        pen = ts.path_length_loss(state, 2, draws)[0]
        out["path_length"] = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(
            g_params, torch.autograd.grad(pen, g_params, allow_unused=True))]
        return out

    rec = RecordingDraws(TorchDraws(torch.Generator().manual_seed(seed + 33)))
    cpu_state = create_train_state(plain_g, plain_d, cfg)
    cpu_state.ada.p = torch.tensor(0.3)
    t0 = time.perf_counter()
    ref = grads(cpu_state, real, rec)
    host_s = time.perf_counter() - t0
    gpu_state = create_train_state(cpu_g.to(DEVICE), cpu_d.to(DEVICE), cfg)
    gpu_state.ada.p = torch.tensor(0.3, device=DEVICE)
    got = grads(gpu_state, real.to(DEVICE), ReplayDraws(rec.records, torch.device(DEVICE)))
    row = {"host_seconds": host_s}
    for name in ref:
        peak = max(float(r.abs().max()) for r in ref[name])
        err = max(float((a.cpu() - r).abs().max()) for a, r in zip(got[name], ref[name]))
        row[name] = {"max_abs_err": err, "peak": peak}
        if not (math.isfinite(err) and peak > 0 and err <= GRAD_TOL * peak):
            raise AssertionError(f"GPU vs CPU {name} gradient: max abs err {err}, peak {peak}")
    print("slice train parity", json.dumps(row), flush=True)
    del gpu_state, got
    empty_cache()
    return row


# --------------------------------------------------------------- train run


TRAIN_RUN_EPOCHS = 4
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


class GridVariants:
    """The upfirdn2d variant of every launch on a batch-15 tensor (the
    sample grids), by wrapping the launch function (counts untouched)."""

    def __enter__(self):
        from multi_stylegan_torch.ops import upfirdn2d as up_mod

        self.mod, self.orig, self.seen = up_mod, up_mod._upfirdn2d_cuda, {}

        def k3(x, kernel, up, down, pad, adjoint=False):
            out = self.orig(x, kernel, up, down, pad, adjoint)
            if x.shape[0] == GRID_BATCH:
                self.seen[(tuple(x.shape), up, down, tuple(pad))] = self.mod.last_variant
            return out
        up_mod._upfirdn2d_cuda = k3
        return self

    def __exit__(self, *exc):
        self.mod._upfirdn2d_cuda = self.orig


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


def host_snapshot(trainer) -> dict:
    """Every tensor and rng state a resumed run depends on, copied to the host."""
    from multi_stylegan_torch.data.pipeline import loader_state
    from multi_stylegan_torch.io.checkpoint import train_state_dict

    flat = {}

    def visit(prefix, value):
        if isinstance(value, dict):
            for k, v in value.items():
                visit(f"{prefix}.{k}", v)
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                visit(f"{prefix}.{i}", v)
        elif hasattr(value, "detach"):
            flat[prefix] = value.detach().cpu().clone()
        else:
            flat[prefix] = value

    visit("state", train_state_dict(trainer.state))
    visit("loader", loader_state(trainer.loader))
    flat["draws"] = trainer.draws.generator.get_state().clone()
    return flat


def phase_train_run(seed: int, iteration_ops: list):
    """The training CLI's whole run at the flagship config on a TLFM TIFF
    tree: trap weights, logger, sample grids, checkpoints, FID / FVD / IS
    with random-weight nets loaded from files, a torch.profiler trace of
    steps 2-5, then a resume.  ``iteration_ops`` (the profiled regularised
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
        # validation every other epoch: each FID pass spends ~25-60 s in
        # scipy's sqrtm of two 2048 x 2048 products on the host, and four of
        # them took 290 s of a 906 s run (NVIDIA H100 80GB HBM3, 700 W)
        overrides = dict(checkpoint_every_n_epochs=1, validate_every_n_epochs=2)
        timer = MethodTimer((Trainer, "_save_sample_grids"), (Trainer, "save_checkpoint"),
                            (metrics.FID, "__call__"), (metrics.FVD, "__call__"),
                            (metrics.IS, "__call__"))
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught, timer, GridVariants() as grids:
            warnings.simplefilter("always")
            zero_counts()
            run = train.main(common + ["--epochs", str(TRAIN_RUN_EPOCHS), "--profile_dir", prof],
                             config_overrides=overrides, validation_samples=TRAIN_RUN_SAMPLES)
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else None
        trainer = run["trainer"]
        failed_saves = [str(w.message) for w in caught if "save failed" in str(w.message)]
        if failed_saves:
            raise AssertionError(f"guarded saves failed: {failed_saves}")
        steps = TRAIN_RUN_EPOCHS * len(dataset) // TRAIN_BATCH
        if not run["finite"] or run["steps"] != steps or trainer.state.step != steps:
            raise AssertionError(f"train run: {run['steps']} steps, finite={run['finite']}")
        if not all(counts.values()):
            raise AssertionError(f"train run: a kernel was never launched: {counts}")
        bad = {k: v for k, v in grids.seen.items() if v == "general" and k[0][-1] != 3}
        if not grids.seen or bad:
            raise AssertionError(f"batch-15 grid sites on the general variant: {bad or 'none seen'}")

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
            raise AssertionError("no profiler trace of steps 2-5")
        top_ops = trainer.trace.top_device_ops(15)
        saved = host_snapshot(trainer)
        ckpt_mb = os.path.getsize(trainer.ckpt.path(steps)) / 2**20
        history = run["history"]
        del run, trainer, cpu_g
        empty_cache()

        # resume: a fresh CLI call on the same experiment, one more epoch
        restored, restore_s = {}, []
        orig_restore = Trainer.restore_latest

        def restore(self, directory=None):
            t0 = time.perf_counter()
            ok = orig_restore(self, directory)
            sync()
            restore_s.append(time.perf_counter() - t0)
            restored.update(host_snapshot(self))
            return ok
        Trainer.restore_latest = restore
        try:
            zero_counts()
            resumed = train.main(common + ["--epochs", "1", "--no_validation_metrics",
                                           "--load_checkpoint", os.path.join(exp, "models")],
                                 config_overrides=overrides)
            resume_counts = read_counts()
        finally:
            Trainer.restore_latest = orig_restore
        differ = [k for k in saved if not (
            torch.equal(saved[k], restored[k]) if hasattr(saved[k], "dtype") else saved[k] == restored[k])]
        if restored.keys() != saved.keys() or differ:
            raise AssertionError(f"restored state differs from the saved one: {differ[:8]}")
        if resumed["state"].step != steps + len(dataset) // TRAIN_BATCH or not resumed["finite"]:
            raise AssertionError(f"resume went to step {resumed['state'].step}")
        del resumed
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
        "resumed_to": steps + len(dataset) // TRAIN_BATCH,
        "loader_ms_per_batch": loader_ms,
        "data_wait_s": [m["data_wait_seconds"] for m in history],
        "step_s": [m["seconds"] for m in history],
        "grid_save_s": secs["Trainer._save_sample_grids"],
        "checkpoint_save_s": secs["Trainer.save_checkpoint"], "checkpoint_restore_s": restore_s,
        "checkpoint_mb": ckpt_mb,
        "metric_s": metric_s, "metric_samples": TRAIN_RUN_SAMPLES,
        "metric_s_scaled_to_5000": {m: [s * PROTOCOL_SAMPLES / TRAIN_RUN_SAMPLES for s in v]
                                    for m, v in metric_s.items()},
        "scores_last": {k: v[-1] for k, v in scores.items()},
        "peak_memory_gib": peak, "launches": counts, "resume_launches": resume_counts,
        "grid_sites": {str(k): v for k, v in grids.seen.items()},
        "grid_sample_max_abs_err": grid_err, "grid_sample_peak": grid_peak,
        "top_device_ops_steps_2_5": top_ops,
        "top_device_ops_regularised_iteration": iteration_ops,
    }
    print("train_run", json.dumps(row), flush=True)
    return {k: counts[k] + resume_counts[k] for k in counts}, row


# --------------------------------------------------------------------- main


KERNELS = {
    "K1": ("fused_leaky_relu", "triton", "multi_stylegan_torch/ops/fused_act.py",
           "multi_stylegan_tpu/ops/pallas_kernels.py:97"),
    "K2": ("fused_leaky_relu_grad", "triton", "multi_stylegan_torch/ops/fused_act.py",
           "multi_stylegan_tpu/ops/pallas_kernels.py:106"),
    "K3": ("upfirdn2d", "cuda", "multi_stylegan_torch/csrc/upfirdn2d.cu",
           "multi_stylegan_tpu/ops/pallas_kernels.py:209"),
    "K4": ("upfirdn2d_grad", "cuda", "multi_stylegan_torch/csrc/upfirdn2d.cu",
           "multi_stylegan_tpu/ops/pallas_kernels.py:337"),
}


def kernel_line(train_rows: dict, sample_report: dict, launches: dict) -> dict:
    """Per kernel: launches over the main-path runs; times, bound and errors
    per regularised training iteration (site time x its launches, summed)."""
    sample_rows = {"K1": sample_report["fused_leaky_relu"], "K3": sample_report["upfirdn2d"]}
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from multi_stylegan_torch.ops import cuda_build

    t_start = t0 = time.perf_counter()
    libs = cuda_build.build_all()
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    seconds = {"build": time.perf_counter() - t0}

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out

    report = phase("kernels", phase_kernels, args.seed)
    counts, slice_row, forward_inputs = phase("sample", phase_slice, args.seed, report)
    if args.profile:
        slice_row["profile"] = phase_profile(*forward_inputs)
    del forward_inputs
    cli_counts, cli_row = phase("train_cli", phase_train_cli, args.seed)
    iter_counts, census, iter_row = phase("train_iteration", phase_train_iteration, args.seed)
    train_rows = phase("grads", phase_grad_sites, args.seed, census)
    parity_row = phase("parity", phase_train_parity, args.seed)
    run_counts, run_row = phase("train_run", phase_train_run, args.seed,
                                iter_row["top_device_ops"])

    sample_counts = {"K1": counts["fused_leaky_relu"], "K2": 0,
                     "K3": counts["upfirdn2d"], "K4": 0}
    launches = {k: sample_counts[k] + cli_counts[k] + iter_counts[k] + run_counts[k]
                for k in KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = kernel_line(train_rows, report, launches)
    seconds["total"] = total = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "sampling_sites": report, "slice": slice_row,
             "train_cli": cli_row, "train_iteration": iter_row, "train_sites": train_rows,
             "train_parity": parity_row, "train_run": run_row, "launches_by_path": {
                 "sample_cli": sample_counts, "train_cli": cli_counts,
                 "train_iteration": iter_counts, "train_run": run_counts},
             "seconds": seconds, **line}, indent=1))
    print("seconds", json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
