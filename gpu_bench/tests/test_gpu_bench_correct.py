"""``correct`` separates a sound run from its control and from each fault the
cell can have, at the tiny configuration on the CPU: the harness's look for
a chip is skipped, the rest of a run drives the port with the timed path
broken underneath, and ``correct`` comes out false.  The control: the
reference one precision below the configuration's reads far above the
program."""

import contextlib

import numpy as np
import pytest
import torch

from gpu_bench import calibrate, run
from gpu_bench.tests.tiny import context, overrides

TRAIN, SAMPLE = "train-msg256-bf16-b24", "sample-msg256-f32-b16"


def execute(cell):
    args = run.parse(["--workload", cell, "--seed", "2600000001", "--seconds", "0.3",
                      "--trace", "0"])
    return run.execute(args, device="cpu", overrides=overrides(cell))


@contextlib.contextmanager
def state_unchanged():
    """Fault: every optimizer step leaves the parameters and moments as they were."""
    from multi_stylegan_torch.train import state

    saved = state.ClippedAdam.step
    state.ClippedAdam.step = lambda self, grads: torch.ones((), dtype=torch.bool)
    try:
        yield
    finally:
        state.ClippedAdam.step = saved


@contextlib.contextmanager
def half_batch_images():
    """Fault: the generator's second half of each batch left out (zeros)."""
    from multi_stylegan_torch.models.generator import Generator

    saved = Generator.forward

    def half(self, *a, **kw):
        images = saved(self, *a, **kw).clone()
        images[images.shape[0] // 2:] = 0
        return images

    Generator.forward = half
    try:
        yield
    finally:
        Generator.forward = saved


@contextlib.contextmanager
def altered_answer():
    """Fault: one sample's frames come out in the wrong order."""
    from multi_stylegan_torch.models.generator import Generator

    saved = Generator.forward

    def altered(self, *a, **kw):
        images = saved(self, *a, **kw).clone()
        images[0] = images[0].flip(1)
        return images

    Generator.forward = altered
    try:
        yield
    finally:
        Generator.forward = saved


@pytest.fixture(scope="module")
def sound():
    """Each cell's compared numbers on a sound run of the same seed."""
    torch.set_num_threads(2)
    return {cell: {name: value for name, value, _ in execute(cell)["checks"]}
            for cell in (TRAIN, SAMPLE)}


@pytest.mark.parametrize("cell,fault", [
    (TRAIN, state_unchanged), (TRAIN, calibrate.half_batch_mean),
    (SAMPLE, half_batch_images), (SAMPLE, altered_answer)])
def test_faults_are_not_correct(cell, fault, sound):
    torch.set_num_threads(2)
    with fault():
        line = execute(cell)
    assert not line["correct"]
    rows = line["checks"]
    assert [row[0] for row in rows] == sorted(row[0] for row in rows)
    # the fault, not the tiny size, is what fails: it reads far above the sound run
    assert max(value / max(sound[cell][name], 1e-12) for name, value, _ in rows) > 10


def test_train_control_reads_far_above_the_program():
    torch.set_num_threads(2)
    ctx = context(TRAIN, seed=11)
    got = calibrate.train_readings(ctx, ["program", "control"])
    prog, ctl = got["program"], got["control"]
    assert max(ctl[k] / max(prog[k], 1e-12) for k in ("loss_gap", "first_grad_gap_d")) > 3


def test_sample_control_reads_above_the_program():
    torch.set_num_threads(2)
    got = calibrate.sample_readings(context(SAMPLE, seed=11), ["program", "control"],
                                    batches=2)
    # TF32 exists on the card only: on the CPU both sides read alike
    assert np.isfinite(got["control"]["image_gap"])
    assert got["program"]["image_gap"] < 1e-5
