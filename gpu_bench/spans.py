"""The program's spans (``multi_stylegan_torch/utils/profiling.py::span``)
against the traced window's device events: the arithmetic of the per-layer
metrics that look inside the training iteration and the generator's
forward.

A span's host interval is on the profiler trace's clock (an event's ``ts``
plus the trace's ``baseTimeNanoseconds`` / 1000).  Each kernel, copy and
set of the window is matched by its ``args.correlation`` to the launch call
that put it on the card, a ``cuda_runtime`` or a ``cuda_driver`` event
(cuBLAS and Triton launch through the driver API).  A span's work is the
device events whose launch call lies inside its host interval; its device
extent runs from the first start to the last end of that work.

A main iteration is a ``train.step`` span without R1 and path length.
Every reader returns None, never 0, when the window has none of its spans
(a program without spans has none), or when more than 1% of the window's
device time has no matched launch.
"""

from __future__ import annotations

import bisect
import functools
import gzip
import json
import os
import statistics
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from gpu_bench import bench, trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the runtime calls that block the host until the card (or a stream) is done
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy", "cudaFree"))
UNMATCHED = 0.01  # the most of the window's device time left without its launch
STEP = "train.step"


class Window:
    """A traced window's device work on the spans' clock (us): each device
    event with its launch call's start and correlation, in launch order; the
    card's busy intervals; the blocking calls' starts."""

    def __init__(self, events: List[dict], base_us: float) -> None:
        events = trace.complete(events)
        lo, hi = trace.window(events)
        self.lo, self.hi = lo + base_us, hi + base_us
        launch: Dict[int, float] = {}
        syncs = []
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = min(launch.get(corr, e["ts"]), e["ts"])
                if e["name"] in SYNCS and lo <= e["ts"] < hi:
                    syncs.append(e["ts"] + base_us)
        work, total, unmatched = [], 0.0, 0.0
        for e in events:
            if e.get("cat") not in trace.DEVICE_CATS or not lo <= e["ts"] < hi:
                continue
            total += e["dur"]
            corr = e.get("args", {}).get("correlation")
            if corr not in launch:
                unmatched += e["dur"]
                continue
            start = e["ts"] + base_us
            work.append((launch[corr] + base_us, corr, start, start + e["dur"]))
        work.sort()
        self.launch = [w[0] for w in work]
        self.corr = [w[1] for w in work]
        self.starts = [w[2] for w in work]
        self.ends = [w[3] for w in work]
        self.busy = trace.union(zip(self.starts, self.ends))
        self._busy_starts = [s for s, _ in self.busy]
        self.syncs = sorted(syncs)
        self.device_us, self.unmatched_us = total, unmatched

    @property
    def matched(self) -> bool:
        """Whether the launches account for the window's device time."""
        return self.device_us > 0 and self.unmatched_us <= UNMATCHED * self.device_us

    def _work(self, r) -> Tuple[int, int]:
        return bisect.bisect_left(self.launch, r.start), bisect.bisect_right(self.launch, r.end)

    def extent(self, r) -> Optional[Tuple[float, float]]:
        """The device extent of span ``r``: None when it launched nothing."""
        i, j = self._work(r)
        return (min(self.starts[i:j]), max(self.ends[i:j])) if j > i else None

    def launches(self, r) -> int:
        """The launch calls of device work inside span ``r``'s host interval."""
        i, j = self._work(r)
        return len(set(self.corr[i:j]))

    def host_syncs(self, r) -> int:
        """The blocking calls inside span ``r``'s host interval."""
        return bisect.bisect_right(self.syncs, r.end) - bisect.bisect_left(self.syncs, r.start)

    def busy_in(self, a: float, b: float) -> float:
        """The card's busy time inside [a, b)."""
        i = max(0, bisect.bisect_right(self._busy_starts, a) - 1)
        total = 0.0
        for s, e in self.busy[i:]:
            if s >= b:
                break
            total += max(0.0, min(e, b) - max(s, a))
        return total


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime: float) -> Window:
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    return Window(doc["traceEvents"], doc.get("baseTimeNanoseconds", 0) / 1e3)


def program_spans() -> Optional[list]:
    """The program's span records, None for a program that keeps none."""
    from multi_stylegan_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def load(run: dict) -> Optional[Tuple[Window, list]]:
    """The run's traced window (read once a process, from the trace that
    ``run.py`` wrote) and the program's finished spans inside it; None when
    the program keeps no spans or the launches do not account for the
    window's device time."""
    records = program_spans()
    if records is None:
        return None
    path = bench.OUT / run["cell"].name / "trace.json.gz"
    if not path.is_file():
        return None
    w = _load(str(path), os.path.getmtime(path))
    if not w.matched:
        return None
    return w, [r for r in records if r.end is not None and w.lo <= r.start < w.hi]


def root(r):
    while r.parent is not None:
        r = r.parent
    return r


def main_steps(records: Sequence) -> list:
    """The main iterations' ``train.step`` spans."""
    return [r for r in records if r.name == STEP and r.parent is None
            and not r.attrs.get("lazy_d") and not r.attrs.get("lazy_g")]


def _ms(ext: Tuple[float, float]) -> float:
    return (ext[1] - ext[0]) / 1e3


def _mean(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return statistics.fmean(values) if values else None


def per_main_iteration(run: dict, names: Sequence[str]) -> Optional[float]:
    """The device extents of the spans named ``names`` in a main iteration
    (its ``train.step`` itself included), summed, in ms; mean over the main
    iterations that ran any of them."""
    got = load(run)
    if got is None:
        return None
    w, records = got
    steps = {id(s): s for s in main_steps(records)}
    sums: Dict[int, float] = {}
    for r in records:
        step = root(r)
        ext = w.extent(r) if r.name in names and id(step) in steps else None
        if ext is not None:
            sums[id(step)] = sums.get(id(step), 0.0) + _ms(ext)
    return _mean(sums.values())


def mean_extent(run: dict, name: str) -> Optional[float]:
    """The device extent of the spans named ``name``, in ms, mean."""
    got = load(run)
    if got is None:
        return None
    w, records = got
    return _mean(_ms(e) for e in (w.extent(r) for r in records if r.name == name) if e)


def per_main_count(run: dict, count: Callable[[Window, object], int]) -> Optional[float]:
    """``count(window, step)`` over the main iterations' ``train.step``
    spans, mean."""
    got = load(run)
    if got is None:
        return None
    w, records = got
    return _mean(count(w, s) for s in main_steps(records))


def main_idle(run: dict) -> Optional[float]:
    """The share of the union of the main iterations' device extents in
    which the card ran nothing, in %."""
    got = load(run)
    if got is None:
        return None
    w, records = got
    merged = trace.union([e for e in (w.extent(s) for s in main_steps(records)) if e])
    length = sum(b - a for a, b in merged)
    if not length:
        return None
    return 100.0 * (1.0 - sum(w.busy_in(a, b) for a, b in merged) / length)
