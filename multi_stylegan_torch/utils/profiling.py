"""Profiling hooks (the port's copy of the JAX package's utils/profiling.py,
on ``torch.profiler`` and CUDA events instead of ``jax.profiler``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


class Trace:
    """A ``torch.profiler`` trace of CPU and (when there is one) CUDA
    activity, written as Chrome JSON into ``log_dir`` when it stops.
    ``start()`` / ``stop()`` bracket a window; ``with trace(dir)`` does both."""

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self.prof: Optional[profile] = None

    def start(self) -> None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def stop(self) -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self.prof.export_chrome_trace(self.path)
        return self.path

    def top_device_ops(self, n: int = 15) -> List[dict]:
        """The ``n`` device kernels with the most time in the window, in ms."""
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in self.prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        return [{"name": k[:120], "ms": ms, "count": c} for k, ms, c in rows[:n]]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Trace]:
    """Trace the enclosed block into ``log_dir``."""
    t = Trace(log_dir)
    t.start()
    try:
        yield t
    finally:
        t.stop()


class StepTimer:
    """Times a block in ms: by CUDA events around it on a CUDA device (the
    device's time for the block's work), else by the host clock."""

    def __init__(self, device: torch.device = torch.device("cpu")) -> None:
        self.device = torch.device(device)
        self.history: List[float] = []

    @contextlib.contextmanager
    def measure(self):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            self.history.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            yield
            self.history.append((time.perf_counter() - t0) * 1e3)

    @property
    def last_ms(self) -> float:
        return self.history[-1]

    def summary(self) -> dict:
        h = np.asarray(self.history)
        return {"mean_ms": float(h.mean()), "p50_ms": float(np.percentile(h, 50)),
                "p90_ms": float(np.percentile(h, 90)), "n": len(h)}
