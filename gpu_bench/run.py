"""Run one cell of the benchmark and print its result as the last line.

    python3 -m gpu_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (building the models from the seed, the kernels' builds and
compiles, the first steps, every shape of the cell warmed) is ``setup_s``:
from the start of this process to the window's.  The window runs the cell's
traffic; with ``--trace 1`` it runs under ``torch.profiler`` and the result
holds the cell's per-layer metrics, else its end-to-end metrics.  Then the
plain reference decides ``correct``; the numbers compared are printed with
their limits, last on standard error and last in the result line.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402 - the clock above starts before the imports
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from gpu_bench import bench  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device, and
    the window, which it enters around its measured work."""

    cell: bench.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    out: Path
    overrides: Dict[str, dict] = dataclasses.field(default_factory=dict)
    setup_s: Optional[float] = None
    window_seconds: Optional[float] = None
    trace_summary: Optional[dict] = None
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    _t0: float = 0.0

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def config_with_overrides(self) -> dict:
        out = dict(self.config)
        for key, kw in self.overrides.items():
            out[key] = {**out.get(key, {}), **kw}
        return out

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @contextlib.contextmanager
    def window(self):
        """The measured window; under ``--trace 1`` profiled, as one
        annotation the trace reader cuts at."""
        self.sync()
        self.setup_s = time.perf_counter() - START
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            mark = record_function("gpu_bench.window")
            mark.__enter__()
        self._t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.sync()
            self.window_seconds = time.perf_counter() - self._t0
            if prof is not None:
                mark.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                t = time.perf_counter()
                self.trace_summary = self._read_trace(prof)
                self.phases["trace_read_s"] = time.perf_counter() - t

    def _read_trace(self, prof) -> dict:
        """Write the trace (gzipped) into this cell's output directory and
        read the window from it."""
        from gpu_bench import trace

        self.out.mkdir(parents=True, exist_ok=True)
        path = self.out / "trace.json"
        prof.export_chrome_trace(str(path))
        summary = trace.summarize(trace.load(str(path)))
        with open(path, "rb") as src, gzip.open(str(path) + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        path.unlink()
        return summary

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def free_device(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", default=0, type=int, choices=(0, 1))
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in bench.FORBIDDEN)


def per_layer(cell: bench.Cell, run: dict) -> Dict[str, dict]:
    """Each per-layer metric whose reader finds something to read."""
    out = {}
    for m in cell.per_layer:
        value = bench.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(args: argparse.Namespace, device=None, overrides=None) -> dict:
    """Run the cell; returns the result line's object (without printing)."""
    import torch

    from gpu_bench import check

    cell = bench.find_cell(args.workload)
    overrides = dict(overrides or {})
    cell.traffic.update(overrides.pop("traffic", {}))
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), torch.device(device),
                  bench.OUT / cell.name, overrides)
    result = cell.driver.run(ctx)
    ctx.phases.update(setup_s=ctx.setup_s, window_s=ctx.window_seconds,
                      total_s=time.perf_counter() - START)
    print("phases " + json.dumps(ctx.phases), file=sys.stderr)
    correct, rows = check.verdict(result["numbers"], cell.name)
    if args.trace:
        metrics = per_layer(cell, {**result, "trace": ctx.trace_summary, "cell": cell})
    else:
        values = {"setup_s": ctx.setup_s, **result["end_to_end"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": result["peak"]}
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dev}
    if args.trace:
        s = ctx.trace_summary
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        line["breakdown"] = {"device_ops": s["top_device_ops"], "idle_gaps": s["idle_gaps"]}
    line["checks"] = rows
    return line


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    # every kernel cache inside the checkout, at a fixed path, before the
    # port (and Triton) are imported
    os.environ["TRITON_CACHE_DIR"] = str(bench.OUT / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(bench.OUT / "torch_extensions")
    import torch

    chips = bench.find_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpu_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    line = execute(args, device="cuda:0")
    found = forbidden_modules()
    if found:
        print(f"gpu_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, value, limit in line["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
