"""The program's spans (utils/profiling.py::span): nothing without a
profiler; under one, on the profiler trace's clock with their parents;
where the work happens in the Trainer's iteration and the path-length
ladder (tiny configs on the CPU); and the benchmark's readers of them
(gpu_bench/spans.py and its metrics) on a hand-made trace."""

import gzip
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpu_bench import bench
from gpu_bench import spans as bench_spans
from multi_stylegan_torch.data.pipeline import make_loader
from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.loop import Trainer
from multi_stylegan_torch.train.steps import StepFlags, TrainStep
from multi_stylegan_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on a few
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recorded_in(fn):
    """The spans ``fn`` recorded."""
    profiling.clear_spans()
    fn()
    return profiling.spans()


def test_span_without_a_profiler_records_nothing():
    a, b = profiling.span("x", k=1), profiling.span("y")
    assert a is b  # the one shared null context

    def use():
        with a as s:
            s.set(ok=True)
    assert _recorded_in(use) == []


def test_spans_on_the_profiler_clock_with_their_parents(tmp_path):
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        def run():
            with profiling.span("outer", step=7) as outer:
                with profiling.span("inner") as inner:
                    torch.mm(x, x)
                    torch.randn(128, 128)  # work after the product inside the span
                inner.set(ok=True)
            assert outer.attrs == {"step": 7}
        recs = _recorded_in(run)
    assert [r.name for r in recs] == ["outer", "inner"]
    outer, inner = recs
    assert outer.parent is None and inner.parent is outer and inner.attrs == {"ok": True}
    assert outer.start <= inner.start < inner.end <= outer.end
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"] / 1e3
    mm = next(e for e in doc["traceEvents"] if e.get("name") == "aten::mm")
    assert inner.start <= mm["ts"] + base and mm["ts"] + base + mm["dur"] <= inner.end


def _tree(records):
    """Each span as (name, its parent's name), in start order."""
    return [(r.name, r.parent.name if r.parent else None) for r in records]


def test_trainer_step_records_its_phases(tmp_path, monkeypatch):
    """A main step with cut-mix, then a lazy step whose path-length update
    runs out of memory unchunked and runs in 2 chunks (the ladder test's
    injected error)."""
    inner = TrainStep.path_length_grads

    def grads(self, state, pld, n_chunks=1):
        if n_chunks == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return inner(self, state, pld, n_chunks)
    monkeypatch.setattr(TrainStep, "path_length_grads", grads)
    g, d = Generator(tiny_generator_config()), Discriminator(tiny_discriminator_config())
    g.reset_parameters(torch.Generator().manual_seed(0))
    d.reset_parameters(torch.Generator().manual_seed(1))
    cfg = TrainingConfig(batch_size=4, lazy_generator_regularization=2,
                         lazy_discriminator_regularization=2)
    loader = make_loader(SyntheticTLFMDataset(n_samples=4, resolution=(32, 32)), 4)
    trainer = Trainer(g, d, cfg, loader, TorchDraws(torch.Generator().manual_seed(0)),
                      epochs=1, data_logger=Logger(experiment_path=str(tmp_path / "exp")))
    trainer.path_length.report = lambda message: None
    real = next(iter(loader))
    with profile(activities=[ProfilerActivity.CPU]):
        recs = _recorded_in(lambda: (
            trainer._run_step(real, StepFlags(do_cut_mix=True), False, False),
            trainer._run_step(real, StepFlags(do_ema=False), True, True)))
    steps = [r for r in recs if r.name == "train.step"]
    assert [s.attrs for s in steps] == [{"step": 1, "lazy_d": False, "lazy_g": False},
                                        {"step": 2, "lazy_d": True, "lazy_g": True}]
    main = [r for r in recs if r is steps[0] or bench_spans.root(r) is steps[0]]
    # every synthesis records one g.stage span a resolution, 4x4 up to
    # 32x32, inside the phase that runs it: the D step's fakes, the G step
    stages = [r for r in main if r.name == "g.stage"]
    assert [r.attrs["px"] for r in stages] == [4, 8, 16, 32] * 2
    assert [r.parent.name for r in stages] == ["train.d_step"] * 4 + ["train.g_step"] * 4
    main = [r for r in main if r.name != "g.stage"]
    assert _tree(main) == [
        ("train.step", None),
        ("train.d_step", "train.step"), ("train.adam", "train.d_step"),
        ("train.cut_mix", "train.step"), ("train.adam", "train.cut_mix"),
        ("train.adam", "train.cut_mix"),
        ("train.g_step", "train.step"), ("train.adam", "train.g_step"),
        ("train.ema", "train.step")]
    lazy = [r for r in recs if (r is steps[1] or bench_spans.root(r) is steps[1])
            and r.name != "g.stage"]
    assert _tree(lazy) == [
        ("train.step", None),
        ("train.d_step", "train.step"), ("train.adam", "train.d_step"),
        ("train.g_step", "train.step"), ("train.adam", "train.g_step"),
        ("train.r1", "train.step"), ("train.adam", "train.r1"),
        ("train.path_length", "train.step"),
        ("train.path_length.tier", "train.path_length"),
        ("train.path_length.tier", "train.path_length"),
        ("train.adam", "train.path_length"), ("train.ema", "train.path_length")]
    tiers = [r.attrs for r in lazy if r.name == "train.path_length.tier"]
    assert tiers == [{"chunks": 1, "ok": False}, {"chunks": 2, "ok": True}]
    n_leaves = len(list(g.parameters()))
    assert {r.attrs["leaves"] for r in recs if r.name == "train.adam"} == {
        n_leaves, len(list(d.parameters()))}
    assert all(r.start <= r.end for r in recs)


# ----------------------------------------------- the benchmark's readers

BASE_NS = 10**12  # the trace's baseTimeNanoseconds: 1e9 us on the spans' clock


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _window_events(unmatched_us=1):
    """The window [0, 1000) (trace time, us).  A main step [100, 400): D step
    (an Adam inside), G step, EMA; a lazy step [500, 900): R1, path
    length; a generator forward [910, 990).  Launches by the runtime and
    (corr 3, 7) the driver API; one kernel without a launch."""
    return [
        _x("user_annotation", "gpu_bench.window", 0, 1000),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 5, 1), _x("kernel", "k", 130, 40, 1),
        _x("cuda_runtime", "cudaMemsetAsync", 160, 5, 2), _x("gpu_memset", "set", 175, 10, 2),
        _x("cuda_driver", "cuLaunchKernel", 220, 5, 3), _x("kernel", "triton", 230, 50, 3),
        _x("cuda_runtime", "cudaMemcpyAsync", 310, 5, 4), _x("gpu_memcpy", "copy", 320, 20, 4),
        _x("cuda_runtime", "cudaStreamSynchronize", 350, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 520, 5, 5), _x("kernel", "r1", 530, 60, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 610, 5, 6), _x("kernel", "pl", 620, 260, 6),
        _x("cuda_driver", "cuLaunchKernel", 920, 5, 7), _x("kernel", "g", 930, 30, 7),
        _x("kernel", "lost", 962, unmatched_us, 99),
    ]


def _span(name, start, end, parent=None, **attrs):
    r = profiling.Span(name, attrs)
    r.parent, r.start, r.end = parent, start + BASE_NS / 1e3, end + BASE_NS / 1e3
    return r


def _records():
    main = _span("train.step", 100, 400, step=1, lazy_d=False, lazy_g=False)
    d = _span("train.d_step", 110, 200, main)
    lazy = _span("train.step", 500, 900, step=2, lazy_d=True, lazy_g=True)
    return [main, d, _span("train.adam", 150, 190, d, leaves=3),
            _span("train.g_step", 210, 300, main), _span("train.ema", 300, 390, main),
            lazy, _span("train.r1", 510, 600, lazy), _span("train.path_length", 600, 890, lazy),
            _span("g.forward", 910, 990)]


def _run(tmp_path, monkeypatch, records, **kw):
    cell = f"cell{len(list(tmp_path.iterdir()))}"
    (tmp_path / cell).mkdir()
    with gzip.open(tmp_path / cell / "trace.json.gz", "wt") as f:
        json.dump({"baseTimeNanoseconds": BASE_NS, "traceEvents": _window_events(**kw)}, f)
    monkeypatch.setattr(bench, "OUT", tmp_path)
    if records is None:  # a program that keeps no spans
        monkeypatch.delattr(profiling, "spans")
    else:
        monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return {"cell": types.SimpleNamespace(name=cell)}


# the readers' values on the hand-made window
EXPECTED = {
    "train_loop.step_span_ms": 0.21,  # [130, 340)
    "train_loop.d_step_ms": 0.055,  # [130, 185)
    "train_loop.cut_mix_ms": None,  # no cut-mix step
    "train_loop.g_step_ms": 0.05,
    "train_loop.optimizer_ms": 0.03,  # Adam's set 10 us + the EMA's copy 20 us
    "train_loop.launches": 4,  # runtime and driver calls with device work
    "train_loop.host_syncs": 1,
    "device.idle.train.main": 100.0 * 90 / 210,  # 120 us busy of [130, 340)
    "regularizers.r1_span_ms": 0.06,
    "regularizers.path_length_span_ms": 0.26,
    "models.g_forward_span_ms": 0.03,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_readers_on_a_hand_made_trace(name, tmp_path, monkeypatch):
    read = bench.metric_reader(name).read
    got = read(_run(tmp_path, monkeypatch, _records()))
    assert got == (None if EXPECTED[name] is None else pytest.approx(EXPECTED[name]))
    # more than 1% of the device time without its launch: nothing
    assert read(_run(tmp_path, monkeypatch, _records(), unmatched_us=10)) is None
    # a window without the reader's spans, and a program without spans: nothing
    assert read(_run(tmp_path, monkeypatch, [])) is None
    assert read(_run(tmp_path, monkeypatch, None)) is None


def test_window_matches_launches_of_both_apis(tmp_path, monkeypatch):
    run = _run(tmp_path, monkeypatch, _records())
    w, records = bench_spans.load(run)
    assert w.matched and w.device_us == 471 and w.unmatched_us == 1
    by_name = {r.name: r for r in records}
    shift = BASE_NS / 1e3
    assert w.extent(by_name["train.g_step"]) == (230 + shift, 280 + shift)  # cuLaunchKernel
    assert w.extent(by_name["train.ema"]) == (320 + shift, 340 + shift)  # a copy
    assert w.launches(by_name["train.d_step"]) == 2 and w.host_syncs(by_name["train.ema"]) == 1
    assert [r.name for r in bench_spans.main_steps(records)] == ["train.step"]
