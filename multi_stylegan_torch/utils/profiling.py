"""Profiling hooks (the port's copy of the JAX package's utils/profiling.py,
on ``torch.profiler`` instead of ``jax.profiler``): a profiler window
written as Chrome JSON (:class:`Trace`), and the program's own spans
(:func:`span`), recorded while a profiler runs.

A span is kept in memory by the program, never as a profiler event: an
annotation of the profiler's own would enclose the card's idle gaps and
rename them after itself wherever a trace reader names a gap by the host
event over it.  Its start and end are host times in us on the profiler
trace's clock (unix time: a profiler event's ``ts`` plus the trace's
``baseTimeNanoseconds`` / 1000), so a reader matches the spans to the
trace's launch calls, and through their correlation ids to the kernels
each span put on the card.  With no profiler running a span costs one flag
read and records nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, List, Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

# the program spans' category and track in an exported trace
CATEGORY = "program"
_TRACK = 1 << 30  # a thread id no real thread of the trace has

_records: List["Span"] = []
_open = threading.local()


def _now_us() -> float:
    return time.time_ns() / 1e3


class Span:
    """One span's record: ``name``, ``parent`` (the span open around it on
    its thread when it started, None at the top), host ``start`` and ``end``
    in us on the profiler trace's clock, and ``attrs``."""

    __slots__ = ("name", "parent", "start", "end", "attrs")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name, self.attrs = name, attrs
        self.parent: Optional[Span] = None
        self.start = self.end = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _open.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self)
        _records.append(self)
        self.start = _now_us()
        return self

    def __exit__(self, *exc) -> None:
        self.end = _now_us()
        _open.stack.pop()


class _NullSpan:
    """What :func:`span` returns while no profiler runs: records nothing."""

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_NULL = _NullSpan()


def span(name: str, **attrs):
    """A context manager that records a span named ``name`` with ``attrs``
    while a ``torch.profiler`` session is active; else the one shared null
    context.  ``set(**attrs)`` on what it yields adds attributes."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NULL
    return Span(name, attrs)


def spans() -> List[Span]:
    """The recorded spans, in the order they started."""
    return list(_records)


def clear_spans() -> None:
    _records.clear()


def add_spans(path: str, records: Sequence[Span]) -> None:
    """Append ``records`` (the finished ones) to the Chrome trace at
    ``path`` as complete events of category ``program`` on a track of
    their own; ``args`` hold each one's attributes, its ``id`` (its index
    in ``records``) and its parent's (``parent``, when among them)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) / 1e3
    pid = os.getpid()
    index = {id(r): i for i, r in enumerate(records)}
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": _TRACK,
                   "args": {"name": "program spans"}})
    for i, r in enumerate(records):
        if r.end is None:
            continue
        args = {**r.attrs, "id": i}
        if r.parent is not None and id(r.parent) in index:
            args["parent"] = index[id(r.parent)]
        events.append({"ph": "X", "cat": CATEGORY, "name": r.name, "pid": pid, "tid": _TRACK,
                       "ts": r.start - base, "dur": r.end - r.start, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


class Trace:
    """A ``torch.profiler`` trace of CPU and (when there is one) CUDA
    activity, written as Chrome JSON into ``log_dir`` when it stops, with
    the program's spans of the window.  ``start()`` / ``stop()`` bracket a
    window; ``with trace(dir)`` does both."""

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self.prof: Optional[profile] = None
        self._t0 = 0.0

    def start(self) -> None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self._t0 = _now_us()
        self.prof.__enter__()

    def stop(self) -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self.prof.export_chrome_trace(self.path)
        add_spans(self.path, [r for r in _records if r.start >= self._t0])
        return self.path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Trace]:
    """Trace the enclosed block into ``log_dir``."""
    t = Trace(log_dir)
    t.start()
    try:
        yield t
    finally:
        t.stop()
