"""A summary of a ``torch.profiler`` Chrome trace of training steps (the
Trainer's ``--profile_dir`` window, utils/profiling.py::Trace): where one
rank's card was busy and where it waited on the host.

The window is cut into segments at the data loader's ``__next__`` markers
(``enumerate(DataLoader)#...__next__``, one per ``next(batches)``): at the
CLI's 4 steps an epoch and its window of steps 2-5 these are steps 2, 3
and 4, the end of the epoch (the ``next`` that ends it, the epoch's logging
and grids) and step 5; inside one epoch (``--labels``) steps 2 to 5.  For
each segment and over the steps (the segments named ``step ...``):

* the card's busy share: the union of its kernels, copies and sets over
  the segment's wall; the device ops, their mean time, and the host's
  kernel launch calls and their time;
* the NCCL all-reduce kernels' time and count;
* the host reads (``aten::_local_scalar_dense``, one per ``float(v)`` of
  a metric): count and host time;

and over those steps the device ops with the most time, the card's idle
time by the length of its gaps, and the longest gaps, each with the host
ops that ran under it.

    python -m multi_stylegan_torch.tools.trace_summary trace.json[.gz] \\
        --out summary.json [--command "..."] [--card "name, limit"] \\
        [--labels "step 2,step 3,step 4,step 5"]
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
NEXT_MARK = "DataLoader"
HOST_READ = "aten::_local_scalar_dense"
LABELS = ("step 2", "step 3", "step 4", "epoch end", "step 5")
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
    """Length of ``merged`` inside [lo, hi)."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def complete(events: List[dict]) -> List[dict]:
    """The complete ('X') events: those with a start and a duration."""
    return [e for e in events if e.get("ph") == "X"]


def segments(events: List[dict], labels: Sequence[str] = LABELS) -> List[dict]:
    """The window of ``events`` (complete ones) cut at the loader's
    ``__next__`` starts, labelled by ``labels`` when their counts agree
    (else ``segment i``)."""
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    marks = sorted(e["ts"] for e in events
                   if e.get("cat") == "user_annotation" and NEXT_MARK in e["name"]
                   and e["name"].endswith("__next__"))
    cuts = [t0] + marks + [t1]
    names = list(labels) if len(labels) == len(cuts) - 1 else [
        f"segment {i}" for i in range(len(cuts) - 1)]
    return [{"label": n, "start": a, "end": b} for n, a, b in zip(names, cuts, cuts[1:])]


def _ms(us: float) -> float:
    return round(us / 1e3, 3)


def summarize(events: List[dict], labels: Sequence[str] = LABELS, top: int = 15,
              gaps: int = 10) -> Dict[str, object]:
    """The summary of ``events`` (their complete ones), the segments named
    by ``labels``."""
    events = complete(events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    merged = union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    nccl = [e for e in device if "nccl" in e["name"].lower() and "allreduce" in e["name"].lower()]
    reads = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == HOST_READ]
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]]
    segs = segments(events, labels)
    for s in segs:
        lo, hi = s.pop("start"), s.pop("end")
        inside = [e for e in nccl if lo <= e["ts"] < hi]
        rd = [e for e in reads if lo <= e["ts"] < hi]
        busy = covered(merged, lo, hi)
        ops = [e["dur"] for e in device if lo <= e["ts"] < hi]
        launched = [e["dur"] for e in launches if lo <= e["ts"] < hi]
        s.update(lo=lo, hi=hi, wall_ms=_ms(hi - lo), device_busy_ms=_ms(busy),
                 busy_share=round(busy / (hi - lo), 4) if hi > lo else None,
                 device_ops=len(ops),
                 mean_device_op_us=round(sum(ops) / len(ops), 2) if ops else None,
                 host_launch_calls=len(launched), host_launch_ms=_ms(sum(launched)),
                 nccl_allreduce_ms=_ms(sum(e["dur"] for e in inside)),
                 nccl_allreduce_count=len(inside), host_reads=len(rd),
                 host_read_ms=_ms(sum(e["dur"] for e in rd)))
    chosen = [s for s in segs if s["label"].startswith("step")]
    spans = [(s["lo"], s["hi"]) for s in chosen]

    def within(e):
        return any(lo <= e["ts"] < hi for lo, hi in spans)

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
    for lo, hi in spans:
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
    wall = sum(hi - lo for lo, hi in spans)
    busy = sum(covered(merged, lo, hi) for lo, hi in spans)
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
        "idle_gaps": [{"ms": _ms(d), "at_ms": _ms(a - min(lo for lo, _ in spans)),
                       "host_ops_under": under(a, b)} for d, a, b in idle[:gaps]],
        "idle_ms_by_gap": {name: _ms(sum(d for d, _, _ in idle if lo <= d < hi))
                           for name, lo, hi in GAP_BINS},
        "idle_gaps_by_gap": {name: sum(lo <= d < hi for d, _, _ in idle)
                             for name, lo, hi in GAP_BINS},
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace")
    ap.add_argument("--out", default=None)
    ap.add_argument("--labels", default=",".join(LABELS),
                    help="The segments' names in order (the Trainer's window inside one "
                         "epoch: 'step 2,step 3,step 4,step 5').")
    ap.add_argument("--command", default=None, help="The command that made the trace.")
    ap.add_argument("--card", default=None, help="nvidia-smi's name and power limit.")
    args = ap.parse_args(argv)
    summary = {"command": args.command, "card": args.card,
               **summarize(load(args.trace), labels=args.labels.split(","))}
    text = json.dumps(summary, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return summary


if __name__ == "__main__":
    main()
