"""Build the port's CUDA C++ sources into shared libraries at first use.

Each ``multi_stylegan_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``<repo>/build/<name>-<hash>.so``, where the hash covers the source and the
flags, so an edited source builds anew and an unchanged one is reused.  The
wrappers load the library with ``ctypes``; nothing includes PyTorch's headers,
which keeps a build to seconds.  ``build_all`` starts one ``nvcc`` per source,
all together, for callers that want every kernel ready up front.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from multi_stylegan_torch/csrc at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    except OSError:
        log.close()
        raise
    return proc, tmp, out, log


def _finish(name: str, started) -> Path:
    if started is None:
        return library_path(name)
    proc, tmp, out, log = started
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        text = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {rc}):\n{text}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library
    return out


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` if needed; returns the library's path."""
    return _finish(name, _start(name))


def build_all() -> Dict[str, Path]:
    """Build every source in ``csrc/``, one nvcc each, all started together."""
    names: List[str] = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    try:
        return {n: _finish(n, started[n]) for n in names}
    finally:  # a failed build must not leave the other compilers running
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
                s[3].close()


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory lines) for a source."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
