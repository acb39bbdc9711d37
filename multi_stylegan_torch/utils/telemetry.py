"""Run telemetry: process title and per-epoch ETA (the port's copy of the JAX
package's utils/telemetry.py; the reference uses the ``rtpt`` package,
model_wrapper.py:129-143).

The title is set with Linux ``prctl(PR_SET_NAME)`` through ctypes (visible
in ``ps`` / ``top``, 15 characters), best effort; the full title and ETA
line is also appended to a log file so that it survives the truncation.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import time
from typing import Optional

_PR_SET_NAME = 15


def set_process_title(title: str) -> bool:
    """Best-effort process (comm) rename; returns True on success."""
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        buf = ctypes.create_string_buffer(title.encode()[:15])
        return libc.prctl(_PR_SET_NAME, buf, 0, 0, 0) == 0
    except (OSError, AttributeError, TypeError):
        return False


class RunTelemetry:
    """Per-epoch ETA: ``start()``, then ``step()`` after every epoch."""

    def __init__(self, experiment_name: str = "MultiStyleGAN", max_iterations: int = 100,
                 log_path: Optional[str] = None) -> None:
        self.experiment_name = experiment_name
        self.max_iterations = max(1, int(max_iterations))
        self.log_path = log_path
        self._t_start: Optional[float] = None
        self._done = 0

    def start(self) -> None:
        self._t_start = time.monotonic()
        set_process_title(f"{self.experiment_name}#first")

    def step(self) -> str:
        """Advance one iteration (epoch); returns the ETA string."""
        self._done += 1
        if self._t_start is None:
            self.start()
        elapsed = time.monotonic() - self._t_start
        remaining = elapsed / self._done * max(0, self.max_iterations - self._done)
        eta = _fmt_duration(remaining)
        set_process_title(f"{self.experiment_name}#{eta}")
        line = (f"{self.experiment_name}: epoch {self._done}/{self.max_iterations}"
                f" elapsed={_fmt_duration(elapsed)} eta={eta}")
        if self.log_path:
            try:
                with open(self.log_path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass
        return eta


def _fmt_duration(seconds: float) -> str:
    seconds = int(max(0, seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h{m:02d}m"
    if m:
        return f"{m}m{s:02d}s"
    return f"{s}s"


def process_title() -> str:
    """This process's comm name, read back."""
    try:
        with open(f"/proc/{os.getpid()}/comm") as f:
            return f.read().strip()
    except OSError:
        return ""
