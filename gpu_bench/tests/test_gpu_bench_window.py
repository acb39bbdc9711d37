"""The training window runs whole lazy cycles and counts its sequences and
lazy iterations; the sampling window counts its batches. Tiny configuration
on the CPU: counts only, no device metric."""

import torch

from gpu_bench.drivers import sample, train
from gpu_bench.tests.tiny import context


def test_train_window_counts():
    torch.set_num_threads(2)
    ctx = context("train-msg256-bf16-b24", seconds=0.5)
    out = train.run(ctx)
    cycle = ctx.config["training"]["lazy_generator_regularization"]
    assert out["attempted"] == cycle  # 0.5 s rounds to the least, one cycle
    assert out["lazy_iterations"] == 1
    assert out["sequences"] == cycle * ctx.traffic["batch"]
    assert set(out["numbers"]) == set(train.COMPARED)


def test_sample_window_counts():
    torch.set_num_threads(2)
    ctx = context("sample-msg256-f32-b16", seconds=0.3)
    out = sample.run(ctx)
    assert out["sequences"] == out["attempted"] * ctx.traffic["batch"] > 0
    assert 1 <= out["checked"] <= ctx.traffic["check_max"]
