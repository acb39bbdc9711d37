"""tools/trace_summary.py on a hand-made Chrome trace (times in us): the
segments at the loader's ``__next__`` markers, the card's busy share, the
NCCL all-reduce time, the host reads and the idle gaps with the host ops
under them."""

import gzip
import json

import pytest

from multi_stylegan_torch.tools import trace_summary

NEXT = "enumerate(DataLoader)#_SingleProcessDataLoaderIter.__next__"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def _trace():
    """Window [0, 300): step 2 [0, 100), step 3 [100, 200), step 4 [200, 300).
    Step 2's card runs [12, 50) and [60, 90) (an all-reduce at [60, 70));
    step 3's [100, 180); step 4's [250, 300), with a host read at [240, 250)."""
    return [
        _x("cpu_op", "aten::conv2d", 0, 95),
        _x("kernel", "conv", 12, 38),
        _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 60, 10),
        _x("kernel", "leaky", 70, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 2),
        _x("user_annotation", NEXT, 100, 1),
        _x("kernel", "conv", 100, 80),
        _x("user_annotation", NEXT, 200, 1),
        _x("cpu_op", "aten::item", 200, 50),
        _x("cpu_op", "aten::_local_scalar_dense", 240, 10),
        _x("gpu_memcpy", "Memcpy DtoH", 250, 50),
        {"ph": "i", "name": "marker", "ts": 0},
    ]


@pytest.mark.parametrize("what", ["segments", "steps", "top_ops", "gaps", "file"])
def test_trace_summary_on_a_hand_made_trace(what, tmp_path):
    labels = ("step 2", "step 3", "step 4")
    s = trace_summary.summarize(_trace(), labels=labels, gaps=3)
    segs = {seg["label"]: seg for seg in s["segments"]}
    if what == "segments":
        assert list(segs) == list(labels)
        assert [segs[k]["wall_ms"] for k in labels] == [0.1, 0.1, 0.1]
        assert [segs[k]["busy_share"] for k in labels] == [0.68, 0.8, 0.5]
        assert segs["step 2"]["nccl_allreduce_ms"] == 0.01
        assert segs["step 2"]["nccl_allreduce_count"] == 1
        assert segs["step 2"]["host_launch_calls"] == 1
        assert [segs[k]["host_reads"] for k in labels] == [0, 0, 1]
        assert segs["step 4"]["host_read_ms"] == 0.01
        # other labels than segments: numbered instead
        parts = trace_summary.segments(trace_summary.complete(_trace()), ("a", "b"))
        assert [x["label"] for x in parts] == [
            "segment 0", "segment 1", "segment 2"]
    elif what == "steps":
        assert s["steps"] == list(labels) and s["steps_wall_ms"] == 0.3 and s["steps_device_busy_ms"] == 0.198
        assert s["steps_busy_share"] == 0.66
        assert s["steps_nccl_allreduce_ms"] == 0.01
    elif what == "top_ops":
        assert [(o["name"], o["ms"], o["count"]) for o in s["top_device_ops"]] == [
            ("conv", 0.118, 2), ("Memcpy DtoH", 0.05, 1), ("leaky", 0.02, 1),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.01, 1)]
    elif what == "gaps":
        # step 4's [200, 250), then step 3's [180, 200), then step 2's [0, 12)
        assert [(g["ms"], g["at_ms"]) for g in s["idle_gaps"]] == [
            (0.05, 0.2), (0.02, 0.18), (0.012, 0.0)]
        under = {o["name"]: o["overlap_ms"] for o in s["idle_gaps"][0]["host_ops_under"]}
        assert under == {"aten::item": 0.05, "aten::_local_scalar_dense": 0.01,
                         NEXT[:100]: 0.001}
        assert s["idle_gaps_by_gap"] == {"under 0.1 ms": 5, "0.1-1 ms": 0, "over 1 ms": 0}
        assert s["idle_ms_by_gap"]["under 0.1 ms"] == 0.102  # 12 + 10 + 10 + 20 + 50 us
    else:
        path = tmp_path / "trace.json.gz"
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": _trace()}, f)
        out = tmp_path / "summary.json"
        got = trace_summary.main([str(path), "--out", str(out), "--labels", ",".join(labels),
                                  "--card", "card, 700.00 W"])
        assert json.loads(out.read_text()) == got
        assert got["card"] == "card, 700.00 W" and got["steps_busy_share"] == s[
            "steps_busy_share"]
