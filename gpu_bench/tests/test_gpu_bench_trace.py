"""The trace arithmetic on a small hand-made Chrome trace: busy share of the
window, the idle gaps and what the host ran under them, kernel time by name,
NCCL all-reduce sums."""

import gzip
import json

import pytest

from gpu_bench import trace


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    event("gpu_bench.window", "user_annotation", 100.0, 1000.0),
    event("before the window", "kernel", 0.0, 50.0),
    event("flr_fwd", "kernel", 100.0, 200.0),
    event("void upfirdn2d_tiled_kernel<float>", "kernel", 250.0, 100.0),  # overlaps
    event("Memcpy DtoH", "gpu_memcpy", 500.0, 100.0),
    event("ncclDevKernel_AllReduce_Sum_f32", "kernel", 800.0, 50.0),
    event("aten::to", "cpu_op", 350.0, 150.0),
    event("aten::randn", "cpu_op", 600.0, 190.0),
    event("cudaLaunchKernel", "cuda_runtime", 640.0, 5.0),
    {"ph": "i", "name": "instant", "ts": 300.0},
]


def test_summary(tmp_path):
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": EVENTS}, f)
    s = trace.summarize(trace.load(str(path)))
    assert s["window_s"] == pytest.approx(1000e-6)
    # busy: [100, 350) + [500, 600) + [800, 850)
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["nccl_allreduce_s"] == pytest.approx(50e-6)
    assert s["idle_gaps"][0] == ["(no host op)", pytest.approx(250e-6)]  # [850, 1100)
    assert s["idle_gaps"][1] == ["aten::randn", pytest.approx(200e-6)]  # [600, 800)
    assert s["idle_gaps"][2] == ["aten::to", pytest.approx(150e-6)]  # [350, 500)
    assert trace.kernel_seconds(s, ("flr_fwd", "upfirdn2d")) == pytest.approx(300e-6)
    assert s["top_device_ops"][0] == ["flr_fwd", pytest.approx(200e-6)]


def test_union():
    assert trace.union([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert trace.covered([(0, 3), (5, 6)], 2, 6) == 2
