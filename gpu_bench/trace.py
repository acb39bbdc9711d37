"""Reading a ``torch.profiler`` Chrome trace over the benchmark's window (a
frozen copy of the arithmetic of ``multi_stylegan_torch/tools/trace_summary.py``):
the card's busy time is the union of its kernels, copies and sets; its idle
time lies in the gaps between them, each named by the host op that ran
longest under it."""

from __future__ import annotations

import bisect
import collections
import gzip
import json
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
WINDOW = "gpu_bench.window"


def load(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged [start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of ``merged`` inside [lo, hi)."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def complete(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def window(events: List[dict]) -> Tuple[float, float]:
    """[start, end) of the benchmark's window annotation, in us."""
    marks = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if len(marks) != 1:
        raise ValueError(f"{len(marks)} window annotations in the trace")
    return marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]


def summarize(events: List[dict], top: int = 10) -> Dict[str, object]:
    """Busy and window seconds, device seconds by op name, the longest idle
    gaps with the host op under each, and the NCCL all-reduce seconds."""
    events = complete(events)
    lo, hi = window(events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS and lo <= e["ts"] < hi]
    merged = union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy = covered(merged, lo, hi)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"]
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and e["name"] != WINDOW),
                  key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    longest = max((e["dur"] for e in host), default=0.0)
    inside = [(s, e) for s, e in merged if e > lo and s < hi]
    edges = [lo] + [x for s, e in inside for x in (max(s, lo), min(e, hi))] + [hi]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                  reverse=True)

    def under(a: float, b: float) -> str:
        """The host op with the most time inside [a, b)."""
        rows: Dict[str, float] = collections.Counter()
        for e in host[bisect.bisect_left(starts, a - longest):bisect.bisect_left(starts, b)]:
            o = min(e["ts"] + e["dur"], b) - max(e["ts"], a)
            if o > 0:
                rows[e["name"][:100]] += o
        return max(rows, key=rows.get) if rows else "(no host op)"

    nccl = [e["dur"] for e in device
            if "nccl" in e["name"].lower() and "allreduce" in e["name"].lower()]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "device_s_by_name": {k: v / 1e6 for k, v in by_name.items()},
        "top_device_ops": [[k[:120], v / 1e6] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[under(a, b), d / 1e6] for d, a, b in gaps[:top]],
        "nccl_allreduce_s": sum(nccl) / 1e6,
    }


def kernel_seconds(summary: Dict[str, object], patterns: Sequence[str]) -> float:
    """The device seconds of the ops whose names hold any of ``patterns``."""
    return sum(s for name, s in summary["device_s_by_name"].items()
               if any(p in name for p in patterns))
