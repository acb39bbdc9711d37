"""The arithmetic of the per-layer metrics' readers (``metrics/<name>.py``).

Each reader takes the traced run (its ``readings``, the ``trace`` summary of
the window) and returns the metric in its unit, or None where it finds
nothing to read; a share is never made up as 0."""

from __future__ import annotations

from typing import Optional

from gpu_bench import flops, kernels, trace


def span_ms(run: dict, key: str) -> Optional[float]:
    value = run["readings"].get(key)
    return None if value is None else value * 1e3


def roofline(run: dict, op: str) -> Optional[float]:
    """The op's launches' least time over its kernels' device time in the
    window, in %.  Nothing when the trace shows no such kernel, or when the
    census and the op's own launch counters disagree."""
    r, summary = run["readings"], run["trace"]
    device_s = trace.kernel_seconds(summary, kernels.NAMES[op])
    if not device_s:
        return None
    kinds = kernels.KINDS[op]
    launches, counters = r["launches"], r["counters"]
    if any(launches.get(k, 0) != counters.get(k, 0) for k in kinds):
        return None
    return 100.0 * kernels.bound_by_op(r["census"])[op] / device_s


def idle(run: dict) -> Optional[float]:
    s = run["trace"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s["window_s"] else None


def mfu(run: dict) -> Optional[float]:
    """The window's model FLOPs at the peak of each one's precision, over
    the window's time, in %."""
    r = run["readings"]
    if not r.get("model_flops") or not r.get("window_s"):
        return None
    return 100.0 * flops.least_seconds(r["model_flops"]) / r["window_s"]
