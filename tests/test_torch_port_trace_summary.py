"""tools/trace_summary.py on a hand-made Chrome trace (times in us): the
segments at the program's ``train.step`` spans, the card's busy share, the
NCCL all-reduce time, the host reads, each step's phases, the idle gaps
with the host ops under them (never a program span) and the idle time by
phase."""

import gzip
import json

import pytest

from multi_stylegan_torch.tools import trace_summary


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0,
            "args": args}


def _trace():
    """Step 2 [0, 100): a D step launching conv [12, 50), a G step launching
    an all-reduce [60, 70) and (by the driver API) leaky [70, 90).  Step 3
    [100, 150) launches conv [104, 180), so its segment runs to 180.  Step 4
    [200, 240) only waits on a stream; then a host read whose copy runs
    [250, 300)."""
    return [
        _x("program", "train.step", 0, 100, step=2, id=0),
        _x("program", "train.d_step", 2, 48, id=1, parent=0),
        _x("program", "train.g_step", 52, 46, id=2, parent=0),
        _x("cpu_op", "aten::conv2d", 0, 95),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 2, correlation=1),
        _x("kernel", "conv", 12, 38, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 55, 2, correlation=2),
        _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 60, 10, correlation=2),
        _x("cuda_driver", "cuLaunchKernel", 58, 1, correlation=3),
        _x("kernel", "leaky", 70, 20, correlation=3),
        _x("program", "train.step", 100, 50, step=3, id=3),
        _x("cuda_runtime", "cudaLaunchKernel", 101, 2, correlation=4),
        _x("kernel", "conv", 104, 76, correlation=4),
        _x("program", "train.step", 200, 40, step=4, id=4),
        _x("cuda_runtime", "cudaStreamSynchronize", 230, 10),
        _x("cpu_op", "aten::item", 240, 50),
        _x("cpu_op", "aten::_local_scalar_dense", 240, 10),
        _x("cuda_runtime", "cudaMemcpyAsync", 241, 1, correlation=5),
        _x("gpu_memcpy", "Memcpy DtoH", 250, 50, correlation=5),
        {"ph": "i", "name": "marker", "ts": 0},
    ]


LABELS = ["step 2", "step 3", "after step 3", "step 4", "after step 4"]


@pytest.mark.parametrize("what", ["segments", "steps", "top_ops", "gaps", "phases", "file"])
def test_trace_summary_on_a_hand_made_trace(what, tmp_path):
    s = trace_summary.summarize(_trace(), gaps=3)
    segs = {seg["label"]: seg for seg in s["segments"]}
    if what == "segments":
        assert list(segs) == LABELS
        assert [segs[k]["wall_ms"] for k in LABELS] == [0.1, 0.08, 0.02, 0.04, 0.06]
        assert [segs[k]["busy_share"] for k in LABELS] == [0.68, 0.95, 0.0, 0.0, 0.8333]
        assert segs["step 2"]["nccl_allreduce_ms"] == 0.01
        assert segs["step 2"]["nccl_allreduce_count"] == 1
        assert segs["step 2"]["host_launch_calls"] == 3  # two runtime, one driver
        assert [segs[k]["host_reads"] for k in LABELS] == [0, 0, 0, 0, 1]
        assert segs["after step 4"]["host_read_ms"] == 0.01
        # a trace without the program's spans: one segment, no step
        bare = [e for e in _trace() if e.get("cat") != "program"]
        assert [x["label"] for x in trace_summary.segments(trace_summary.complete(bare))] == [
            "window"]
    elif what == "steps":
        assert s["steps"] == ["step 2", "step 3", "step 4"]
        assert s["steps_wall_ms"] == 0.22 and s["steps_device_busy_ms"] == 0.144
        assert s["steps_busy_share"] == 0.6545
        assert s["steps_nccl_allreduce_ms"] == 0.01
    elif what == "top_ops":
        assert [(o["name"], o["ms"], o["count"]) for o in s["top_device_ops"]] == [
            ("conv", 0.114, 2), ("leaky", 0.02, 1),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.01, 1)]
    elif what == "gaps":
        # step 4's [200, 240), step 2's [0, 12), then its [90, 100)
        assert [(g["ms"], g["at_ms"]) for g in s["idle_gaps"]] == [
            (0.04, 0.2), (0.012, 0.0), (0.01, 0.09)]
        # named by host ops alone: the program's train.step over it is none
        under = {o["name"]: o["overlap_ms"] for o in s["idle_gaps"][0]["host_ops_under"]}
        assert under == {"cudaStreamSynchronize": 0.01}
        assert s["idle_gaps_by_gap"] == {"under 0.1 ms": 5, "0.1-1 ms": 0, "over 1 ms": 0}
        assert s["idle_ms_by_gap"]["under 0.1 ms"] == 0.076  # 12 + 10 + 10 + 4 + 40 us
    elif what == "phases":
        row = dict(count=1, busy_ms=0.0, idle_ms=0.0, host_syncs=0)
        assert segs["step 2"]["phases"] == {
            "train.step": dict(row, host_ms=0.1, device_ms=0.078, busy_ms=0.068, idle_ms=0.01,
                               launches=3),
            "train.d_step": dict(row, host_ms=0.048, device_ms=0.038, busy_ms=0.038,
                                 launches=1),
            "train.g_step": dict(row, host_ms=0.046, device_ms=0.03, busy_ms=0.03, launches=2)}
        assert segs["step 4"]["phases"] == {
            "train.step": dict(row, host_ms=0.04, device_ms=0.0, launches=0, host_syncs=1)}
        # the idle time by phase adds up to the trace's: 300 us less 194 busy
        assert s["idle_ms_by_phase"] == {"train.step": 0.076, "train.d_step": 0.0,
                                         "train.g_step": 0.0, "outside steps": 0.03}
    else:
        path = tmp_path / "trace.json.gz"
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": _trace()}, f)
        out = tmp_path / "summary.json"
        got = trace_summary.main([str(path), "--out", str(out), "--card", "card, 700.00 W"])
        assert json.loads(out.read_text()) == got
        assert got["card"] == "card, 700.00 W" and got["steps_busy_share"] == s[
            "steps_busy_share"]
