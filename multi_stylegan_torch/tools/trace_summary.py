"""A summary of a ``torch.profiler`` Chrome trace of training steps (the
Trainer's ``--profile_dir`` window, utils/profiling.py::Trace): where one
rank's card was busy and where it waited on the host, step by step and
phase by phase.

The trace holds the program's spans (category ``program``, on the
profiler's clock).  Each ``train.step`` span opens a segment ``step <n>``
that runs until the later of its own end and the end of the last device
op it launched; the stretches between (the loader, the host reads, the
end of an epoch) are segments ``before step <n>`` / ``after step <n>``.  A
device op belongs to the span whose host interval holds its launch call,
matched through ``args.correlation`` (runtime or driver API).  For each
segment and over the steps (the segments named ``step ...``):

* the card's busy share: the union of its kernels, copies and sets over
  the segment's wall; the device ops, their mean time, and the host's
  kernel launch calls and their time;
* the NCCL all-reduce kernels' time and count;
* the host reads (``aten::_local_scalar_dense``, one per ``float(v)`` of
  a metric): count and host time;
* each step's phases (its ``train.step`` and the spans inside it, by
  name): their count, host time, device extent (first start to last end
  of the ops they launched), the busy and idle time inside that extent,
  their launch calls and their blocking calls;

and over those steps the device ops with the most time, the card's idle
time by the length of its gaps, and the longest gaps, each with the host
ops that ran under it.  Over the whole trace, the card's idle time by
phase: each instant counts for the ``train.step`` child whose device
extent holds it, else for ``train.step`` inside a step segment, else for
``outside steps``.

    python -m multi_stylegan_torch.tools.trace_summary trace.json[.gz] \\
        --out summary.json [--command "..."] [--card "name, limit"]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gzip
import json
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PROGRAM = "program"
STEP = "train.step"
HOST_READ = "aten::_local_scalar_dense"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cudaFree")
OUTSIDE = "outside steps"
GAP_BINS = (("under 0.1 ms", 0, 100), ("0.1-1 ms", 100, 1e3), ("over 1 ms", 1e3, float("inf")))


def load(path: str) -> List[dict]:
    """The events of a Chrome trace, plain or gzipped."""
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
    """Length of ``merged`` (sorted, disjoint) inside [lo, hi)."""
    total = 0.0
    for s, e in merged[max(0, bisect.bisect_right(merged, (lo, float("inf"))) - 1):]:
        if s >= hi:
            break
        total += max(0.0, min(e, hi) - max(s, lo))
    return total


def complete(events: List[dict]) -> List[dict]:
    """The complete ('X') events: those with a start and a duration."""
    return [e for e in events if e.get("ph") == "X"]


class Launches:
    """The device ops in the order of their launch calls' starts."""

    def __init__(self, events: List[dict]) -> None:
        at: Dict[int, float] = {}
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                at[corr] = min(at.get(corr, e["ts"]), e["ts"])
        ops = sorted((at[c], c, e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") in DEVICE_CATS
                     and (c := e.get("args", {}).get("correlation")) in at)
        self.launch = [o[0] for o in ops]
        self.ops = ops

    def inside(self, lo: float, hi: float) -> list:
        """(launch, correlation, start, end) of the ops launched in [lo, hi]."""
        return self.ops[bisect.bisect_left(self.launch, lo):bisect.bisect_right(self.launch, hi)]

    def extent(self, lo: float, hi: float) -> Optional[Tuple[float, float]]:
        ops = self.inside(lo, hi)
        return (min(o[2] for o in ops), max(o[3] for o in ops)) if ops else None


def _children(spans: List[dict], step: dict) -> List[dict]:
    """The program spans inside ``step`` (all depths): those whose chain of
    ``parent`` ids reaches its ``id``."""
    parent = {s["args"]["id"]: s["args"].get("parent") for s in spans}

    def under(s):
        p = s["args"].get("parent")
        while p is not None and p != step["args"]["id"]:
            p = parent.get(p)
        return p is not None

    return [s for s in spans if under(s)]


def segments(events: List[dict], launches: Optional[Launches] = None) -> List[dict]:
    """The trace (its complete events) cut into step segments at the
    program's ``train.step`` spans and the stretches between them."""
    launches = launches or Launches(events)
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    steps = sorted((e for e in events if e.get("cat") == PROGRAM and e["name"] == STEP),
                   key=lambda e: e["ts"])
    out, at = [], t0
    for i, s in enumerate(steps):
        n = s.get("args", {}).get("step", i)
        ext = launches.extent(s["ts"], s["ts"] + s["dur"])
        end = max(s["ts"] + s["dur"], ext[1] if ext else s["ts"])
        if s["ts"] > at:
            label = f"after step {out[-1]['step']}" if out else f"before step {n}"
            out.append({"label": label, "start": at, "end": s["ts"]})
        out.append({"label": f"step {n}", "step": n, "start": max(s["ts"], at), "end": end,
                    "span": s})
        at = end
    if t1 > at or not out:
        out.append({"label": f"after step {out[-1]['step']}" if out else "window",
                    "start": at, "end": t1})
    return out


def _ms(us: float) -> float:
    return round(us / 1e3, 3)


def _phases(spans: List[dict], step: dict, launches: Launches, merged, syncs) -> Dict[str, dict]:
    """The phases of one step: its ``train.step`` span and the spans
    inside it, by name."""
    out: Dict[str, dict] = {}
    for s in [step] + _children(spans, step):
        lo, hi = s["ts"], s["ts"] + s["dur"]
        ops = launches.inside(lo, hi)
        row = out.setdefault(s["name"], dict.fromkeys(
            ("count", "host_ms", "device_ms", "busy_ms", "idle_ms", "launches", "host_syncs"), 0))
        row["count"] += 1
        row["host_ms"] += s["dur"] / 1e3
        row["launches"] += len({o[1] for o in ops})
        row["host_syncs"] += sum(lo <= t <= hi for t in syncs)
        if ops:
            a, b = min(o[2] for o in ops), max(o[3] for o in ops)
            busy = covered(merged, a, b)
            row["device_ms"] += (b - a) / 1e3
            row["busy_ms"] += busy / 1e3
            row["idle_ms"] += (b - a - busy) / 1e3
    return {k: {f: round(v, 3) for f, v in row.items()} for k, row in out.items()}


def idle_by_phase(segs: List[dict], spans: List[dict], launches: Launches,
                  merged) -> Dict[str, float]:
    """The trace's idle time (ms) by phase: the direct children of each
    ``train.step`` by their device extents, the rest of the step segments
    as ``train.step``, everything else as ``outside steps``."""
    parts: List[Tuple[float, float, str]] = []
    for seg in segs:
        step = seg.get("span")
        if step is None:
            parts.append((seg["start"], seg["end"], OUTSIDE))
            continue
        at = seg["start"]
        kids = [s for s in spans if s["args"].get("parent") == step["args"]["id"]]
        exts = sorted((e[0], e[1], s["name"]) for s in kids
                      if (e := launches.extent(s["ts"], s["ts"] + s["dur"])))
        for a, b, name in exts:
            a = max(a, at)
            if b <= a:
                continue
            parts.append((at, a, STEP))
            parts.append((a, min(b, seg["end"]), name))
            at = min(b, seg["end"])
        parts.append((at, seg["end"], STEP))
    out: Dict[str, float] = collections.defaultdict(float)
    for a, b, name in parts:
        if b > a:
            out[name] += (b - a - covered(merged, a, b)) / 1e3
    return {k: round(v, 3) for k, v in out.items()}


def summarize(events: List[dict], top: int = 15, gaps: int = 10) -> Dict[str, object]:
    """The summary of ``events`` (their complete ones)."""
    events = complete(events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    merged = union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    nccl = [e for e in device if "nccl" in e["name"].lower() and "allreduce" in e["name"].lower()]
    reads = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == HOST_READ]
    launch_calls = [e for e in events if e.get("cat") in LAUNCH_CATS and "Launch" in e["name"]]
    syncs = sorted(e["ts"] for e in events if e.get("cat") == "cuda_runtime"
                   and e["name"] in SYNCS)
    spans = [e for e in events if e.get("cat") == PROGRAM]
    launches = Launches(events)
    segs = segments(events, launches)
    by_phase = idle_by_phase(segs, spans, launches, merged)
    for s in segs:
        lo, hi, step = s.pop("start"), s.pop("end"), s.pop("span", None)
        s.pop("step", None)
        inside = [e for e in nccl if lo <= e["ts"] < hi]
        rd = [e for e in reads if lo <= e["ts"] < hi]
        busy = covered(merged, lo, hi)
        ops = [e["dur"] for e in device if lo <= e["ts"] < hi]
        launched = [e["dur"] for e in launch_calls if lo <= e["ts"] < hi]
        s.update(lo=lo, hi=hi, wall_ms=_ms(hi - lo), device_busy_ms=_ms(busy),
                 busy_share=round(busy / (hi - lo), 4) if hi > lo else None,
                 device_ops=len(ops),
                 mean_device_op_us=round(sum(ops) / len(ops), 2) if ops else None,
                 host_launch_calls=len(launched), host_launch_ms=_ms(sum(launched)),
                 nccl_allreduce_ms=_ms(sum(e["dur"] for e in inside)),
                 nccl_allreduce_count=len(inside), host_reads=len(rd),
                 host_read_ms=_ms(sum(e["dur"] for e in rd)))
        if step is not None:
            s["phases"] = _phases(spans, step, launches, merged, syncs)
    chosen = [s for s in segs if s["label"].startswith("step")]
    spans_at = [(s["lo"], s["hi"]) for s in chosen]

    def within(e):
        return any(lo <= e["ts"] < hi for lo, hi in spans_at)

    by_name: Dict[str, List[float]] = collections.defaultdict(list)
    for e in device:
        if within(e):
            by_name[e["name"]].append(e["dur"])
    device_ms = sum(sum(v) for v in by_name.values())
    top_ops = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]

    host = sorted((e for e in events if e.get("cat") in HOST_CATS), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    longest = max((e["dur"] for e in host), default=0.0)
    idle = []
    for lo, hi in spans_at:
        inside = [(s, e) for s, e in merged if e > lo and s < hi]
        edges = [lo] + [x for s, e in inside for x in (max(s, lo), min(e, hi))] + [hi]
        idle += [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle.sort(reverse=True)

    def under(a: float, b: float, n: int = 6) -> List[dict]:
        """The host ops overlapping [a, b), by overlap."""
        first = bisect.bisect_left(starts, a - longest)
        rows = collections.Counter()
        for e in host[first:bisect.bisect_left(starts, b)]:
            o = min(e["ts"] + e["dur"], b) - max(e["ts"], a)
            if o > 0:
                rows[(e["cat"], e["name"][:100])] += o
        return [{"cat": c, "name": n_, "overlap_ms": _ms(o)} for (c, n_), o in rows.most_common(n)]

    for s in segs:
        s.pop("lo"), s.pop("hi")
    wall = sum(hi - lo for lo, hi in spans_at)
    busy = sum(covered(merged, lo, hi) for lo, hi in spans_at)
    return {
        "segments": segs,
        "steps": [s["label"] for s in chosen],
        "steps_wall_ms": _ms(wall),
        "steps_device_busy_ms": _ms(busy),
        "steps_busy_share": round(busy / wall, 4) if wall else None,
        "steps_nccl_allreduce_ms": round(sum(s["nccl_allreduce_ms"] for s in chosen), 3),
        "steps_host_read_ms": round(sum(s["host_read_ms"] for s in chosen), 3),
        "top_device_ops": [{"name": k[:120], "ms": _ms(sum(v)), "count": len(v),
                            "share_of_device_time": round(sum(v) / device_ms, 4)}
                           for k, v in top_ops],
        "idle_gaps": [{"ms": _ms(d), "at_ms": _ms(a - min(lo for lo, _ in spans_at)),
                       "host_ops_under": under(a, b)} for d, a, b in idle[:gaps]],
        "idle_ms_by_gap": {name: _ms(sum(d for d, _, _ in idle if lo <= d < hi))
                           for name, lo, hi in GAP_BINS},
        "idle_gaps_by_gap": {name: sum(lo <= d < hi for d, _, _ in idle)
                             for name, lo, hi in GAP_BINS},
        "idle_ms_by_phase": by_phase,
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace")
    ap.add_argument("--out", default=None)
    ap.add_argument("--command", default=None, help="The command that made the trace.")
    ap.add_argument("--card", default=None, help="nvidia-smi's name and power limit.")
    args = ap.parse_args(argv)
    summary = {"command": args.command, "card": args.card, **summarize(load(args.trace))}
    text = json.dumps(summary, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return summary


if __name__ == "__main__":
    main()
