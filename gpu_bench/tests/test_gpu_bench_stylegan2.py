"""The StyleGAN2 sampling driver at a tiny one-tower configuration on the
CPU: its window counts batches, ``correct`` holds against the plain
StyleGAN2 reference, and the faults it must catch read far above the
limit."""

import numpy as np
import torch

from gpu_bench import check
from gpu_bench.drivers import sample_stylegan2
from gpu_bench.tests.tiny import context

CELL = "sample-sg2f1024-f32-b16"


def test_window_counts_and_is_correct():
    torch.set_num_threads(2)
    ctx = context(CELL, seconds=0.3)
    assert ctx.config_with_overrides()["generator"]["num_domains"] == 1
    out = sample_stylegan2.run(ctx)
    assert out["sequences"] == out["attempted"] * ctx.traffic["batch"] > 0
    assert 1 <= out["checked"] <= ctx.traffic["check_max"]
    correct, rows = check.verdict(out["numbers"], CELL)
    assert correct, rows


def test_faults_read_far_above_the_limit():
    torch.set_num_threads(2)
    got = sample_stylegan2.readings(context(CELL, seed=11), ["faults", "control"], batches=2)
    limit = check.limits(CELL)["image_gap"]
    assert got["program"]["image_gap"] < limit / 10
    assert min(got["half_batch"]["image_gap"], got["altered"]["image_gap"]) > 10 * limit
    # TF32 exists on the card only: on the CPU both sides read alike
    assert np.isfinite(got["control"]["image_gap"])
