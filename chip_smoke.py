#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Multi-StyleGAN on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--seed 0] [--profile]

Run from the root of a checkout.  It imports only the port
(``multi_stylegan_torch``) and PyTorch, never JAX or the JAX package, and
exits non-zero without a result when CUDA is unavailable or the port is not
beside it.  Phases, each raising on failure:

1. build    - compile every CUDA source of the port (one nvcc per source,
              started together) and print ptxas' register lines.
2. kernels  - hold each hand-written kernel against its plain PyTorch
              version on the card, in f32 and bf16, at every call-site
              shape of the sampling path at batch 16 plus edge cases; time
              kernel, plain version and library yardstick in f32 with CUDA
              events, and compute each site's bound from its bytes and
              operations.
3. slice    - write a random-weight reference-format checkpoint of the full
              256x256 generator, run ``multi_stylegan_torch.cli.sample`` on it
              (32 samples at batch 16) with the launch counts zeroed just
              before, check the PNGs, finiteness and 34 fused-leaky-ReLU /
              24 upfirdn2d launches per forward, then match one sample
              against the port on the CPU (plain versions, same weights and
              noise) and time a batch-16 forward.

Prints one ``site`` line per kernel call site, the card's name and power
limit, one ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}``
line.  In the kernels line ``launches`` counts the whole CLI run (two
batch-16 forwards), while ``ms``, ``plain_ms``, ``bound_ms`` and
``library_ms`` are per batch-16 forward: each site's time per launch times
its launches per forward, summed over the sites.
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
    return float((got.float() - ref.float()).abs().max())


def check(name: str, got, ref, dtype_name: str) -> float:
    import torch

    torch.cuda.synchronize()
    err = max_err(got, ref)
    peak = float(ref.float().abs().max())
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
    """Edge cases (B=2): the Pallas kernel's test shapes at C=128 and 256,
    then general up/down/pads the generator does not use."""
    cases = [((2, h, w, 128), 1, 1, pad, k) for pad, k, h, w in [
        ((2, 2), 4, 16, 16), ((2, 1), 4, 17, 16), ((1, 1), 3, 32, 16),
        ((2, 1), 4, 8, 8), ((3, 3), 4, 16, 8), ((3, 3), 4, 31, 16),
        ((3, 3), 4, 33, 16), ((0, 0), 4, 16, 16)]]
    cases += [((1, 16, 16, 256), 1, 1, (2, 1), 4),
              ((2, 9, 11, 3), 2, 1, (3, 1), 4), ((2, 9, 11, 3), 1, 2, (1, 1), 4),
              ((2, 9, 11, 5), 1, 1, (-1, 2), 4), ((2, 9, 11, 7), 2, 2, (1, 2, 0, 3), 3),
              ((2, 8, 8, 130), 2, 1, (2, 1), 4)]
    return cases


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

    dev = torch.device("cuda")
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

    # K3 edge cases: correctness only
    edge_err = {"float32": 0.0, "bfloat16": 0.0}
    for shape, up, down, pad, k in upfirdn_edge_cases():
        taps = torch.randn((k, k), generator=g, device=dev)
        for name, dt in dtypes.items():
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            got = up_mod.upfirdn2d(x, taps, up, down, pad)
            edge_err[name] = max(edge_err[name], check(
                f"upfirdn2d edge {shape} up={up} down={down} pad={pad}",
                got, up_mod.upfirdn2d_ref(x, taps, up, down, pad), name))
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


# --------------------------------------------------------------------- main


def kernel_line(report: dict, counts: dict) -> dict:
    meta = {
        "fused_leaky_relu": ("triton", "multi_stylegan_torch/ops/fused_act.py",
                             "multi_stylegan_tpu/ops/pallas_kernels.py:97"),
        "upfirdn2d": ("cuda", "multi_stylegan_torch/csrc/upfirdn2d.cu",
                      "multi_stylegan_tpu/ops/pallas_kernels.py:209"),
    }
    out = []
    for name, (route, source, replaces) in meta.items():
        rows = report[name]

        def per_forward(key):
            vals = [r[key] for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(v * r["launches_per_forward"] for v, r in zip(vals, rows))

        t_bytes = sum(r["bound_ms"] * r["launches_per_forward"] for r in rows
                      if r["bound_by"] == "bytes")
        out.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err_float32"] for r in rows),
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": "bytes" if t_bytes >= 0.5 * per_forward("bound_ms") else "operations",
            "library_ms": per_forward("library_ms"),
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

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    report = phase_kernels(args.seed)
    counts, slice_row, forward_inputs = phase_slice(args.seed, report)
    if args.profile:
        slice_row["profile"] = phase_profile(*forward_inputs)

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = kernel_line(report, counts)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "sites": report, "slice": slice_row, **line}, indent=1))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
