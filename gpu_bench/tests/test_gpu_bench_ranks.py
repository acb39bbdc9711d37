"""The ranked training driver over two gloo ranks on the CPU at the tiny
configuration: a whole lazy cycle at the global batch, rank 0's counts, and
``correct`` against the reference run over the same ranks."""

import torch

from gpu_bench import check
from gpu_bench.drivers import train, train_ranks
from gpu_bench.tests.tiny import context

CELL = "train4-msg256-bf16-b96"


def test_two_ranks_are_correct():
    torch.set_num_threads(2)
    ctx = context(CELL, seed=2600000003, seconds=0.5)
    ctx.cell.chips = 2  # two gloo ranks share the CPU
    out = train_ranks.run(ctx)
    cycle = ctx.config["training"]["lazy_generator_regularization"]
    assert out["attempted"] == cycle and out["lazy_iterations"] == 1
    assert out["sequences"] == cycle * ctx.traffic["batch"]
    assert ctx.setup_s > 0 and ctx.window_seconds > 0
    assert set(out["numbers"]) == set(train.COMPARED)
    correct, rows = check.verdict(out["numbers"], CELL)
    assert correct, rows
