"""The training CLI with tensor-parallel ranks on the CPU (tiny configs):
``--model_parallel 2 --device cpu`` spawns a (data 1, model 2) mesh of gloo
ranks.  Four spawns: 2 epochs with R1 and path length on their lazy steps,
a resume of its first checkpoint, a resume of one process's checkpoint,
and an epoch in bf16 with ADA's sequential warps;
against one process at the same global batch, which also resumes the
tensor-parallel checkpoint.  Then the sampling CLI reads the run's
checkpoints, and the layout arithmetic of the flags in one process.

``--resume_training`` turns wrong order and cut-mix on from the first step;
the lazy regularisers run every 4 steps here (a 4-step epoch) instead of 16.
"""

import os
import sys

import numpy as np
import pytest
import torch

from multi_stylegan_torch.cli import sample as sample_cli
from multi_stylegan_torch.cli import train as train_cli
from multi_stylegan_torch.io.checkpoint import read_checkpoint
from multi_stylegan_torch.parallel import mesh

BATCH = 16  # global; 64 fixture sequences make 4 steps an epoch
BASE = ["--tiny", "--synthetic", "--device", "cpu", "--batch_size", str(BATCH), "--seed", "3",
        "--resume_training", "--no_validation_metrics"]
TP = ["--model_parallel", "2"]
OVERRIDES = {"checkpoint_every_n_epochs": 1, "lazy_discriminator_regularization": 4,
             "lazy_generator_regularization": 4}
LOSSES = ("loss_discriminator_real", "loss_discriminator_fake", "loss_generator",
          "loss_cut_mix_augmentation", "loss_discriminator_real_pixel_wise", "ada_r",
          "loss_discriminator_regularization", "loss_path_length_regularization")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, and so in each spawned rank (the CLI gives its
    CPU ranks this process's threads shared out)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _main_capturing(log, argv):
    """``cli.train.main`` with file descriptor 1 (the spawned ranks' too)
    sent to ``log``."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(log, "w") as f:
            os.dup2(f.fileno(), 1)
            return train_cli.main(argv, config_overrides=OVERRIDES)
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_cli")

    def run(name, epochs, *extra):
        return _main_capturing(root / f"{name}.log", BASE + [
            "--epochs", str(epochs), "--experiment_path", str(root / name), *extra])

    out = {"root": root}
    out["tp"] = run("tp", 2, *TP)
    out["one"] = run("one", 1)
    tp4, one4 = (str(root / n / "models" / "checkpoint_4.pt") for n in ("tp", "one"))
    out["tp_resumed"] = run("tp_resumed", 1, *TP, "--load_checkpoint", tp4)
    out["one_from_tp"] = run("one_from_tp", 1, "--load_checkpoint", tp4)
    out["tp_from_one"] = run("tp_from_one", 1, *TP, "--load_checkpoint", one4)
    out["tp_bf16"] = run("tp_bf16", 1, *TP, "--dtype", "bfloat16", "--ada_sequential_warps")
    return out


def _close(got, ref, what, first_step=1):
    assert len(got) == len(ref) == 4
    for step, (a, b) in enumerate(zip(ref, got), start=first_step):
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4 * step, atol=1e-6,
                                       err_msg=f"{what}: step {step} {k}")


def test_cli_model_parallel_trains_with_the_regularisers_and_one_writer(runs):
    root = runs["root"]
    log = (root / "tp.log").read_text()
    assert runs["tp"]["steps"] == 8 and runs["tp"]["finite"]
    assert log.count("Start training") == 1 and log.count("2 rank(s) (1 data x 2 model)") == 1
    assert [log.count(f"step {s}:") for s in range(1, 9)] == [1] * 8
    hist = runs["tp"]["history"]
    assert [m["loss_discriminator_regularization"] > 0 for m in hist] == [False, False, False,
                                                                         True] * 2
    assert [m["path_length"] > 0 for m in hist] == [False, False, False, True] * 2
    exp = root / "tp"
    assert sorted(os.listdir(exp / "models")) == ["checkpoint_4.pt", "checkpoint_8.pt"]
    assert len(np.load(exp / "metrics" / "loss_generator.npy")) == 8
    assert len(os.listdir(exp / "plots")) == 2 * 2 * 2 * 15 * 2  # grids: 2 epochs, once
    assert len(read_checkpoint(str(exp / "models"))["loader"]) == 1  # one data rank


def test_cli_model_parallel_matches_one_process(runs):
    """The same batches, draws and flags give the same losses up to the
    order of the sums (which the parameters carry forward step by step)."""
    _close(runs["tp"]["history"][:4], runs["one"]["history"], "one process")


def test_cli_model_parallel_checkpoint_has_the_one_process_layout(runs):
    """The tensor-parallel run's checkpoint holds the same tensors, of the
    same shapes, as one process's."""
    tp = read_checkpoint(str(runs["root"] / "tp" / "models" / "checkpoint_4.pt"))
    one = read_checkpoint(str(runs["root"] / "one" / "models" / "checkpoint_4.pt"))
    a, b = mesh.tensors_of(tp["train_state"]), mesh.tensors_of(one["train_state"])
    assert len(a) == len(b) > 100
    assert [x.shape for x in a] == [y.shape for y in b]


def test_cli_model_parallel_resume_is_bitwise(runs):
    root = runs["root"]
    assert runs["tp_resumed"]["history"] == [
        {**m, "seconds": r["seconds"], "data_wait_seconds": r["data_wait_seconds"]}
        for m, r in zip(runs["tp"]["history"][4:], runs["tp_resumed"]["history"])]
    a = read_checkpoint(str(root / "tp" / "models" / "checkpoint_8.pt"))
    b = read_checkpoint(str(root / "tp_resumed" / "models" / "checkpoint_8.pt"))
    flat_a, flat_b = mesh.tensors_of(a["train_state"]), mesh.tensors_of(b["train_state"])
    assert len(flat_a) == len(flat_b) > 100
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    assert a["loader"] == b["loader"] and torch.equal(a["draws"], b["draws"])


@pytest.mark.parametrize("run,ref", [("one_from_tp", "tp"), ("tp_from_one", "tp")])
def test_cli_checkpoints_resume_across_layouts(runs, run, ref):
    """One process resumes the tensor-parallel checkpoint, and the
    tensor-parallel ranks one process's, on the uninterrupted run's course."""
    _close(runs[run]["history"], runs[ref]["history"][4:], run, first_step=5)


def test_cli_model_parallel_composes_with_bf16_and_sequential_warps(runs):
    """bf16 main steps (R1 and path length in f32 at step 4) with ADA's four
    sequential warps, on two model ranks: every metric finite, the losses
    near the f32 run's first step (bf16 rounding)."""
    hist = runs["tp_bf16"]["history"]
    assert runs["tp_bf16"]["finite"] and len(hist) == 4
    assert hist[3]["loss_discriminator_regularization"] > 0 and hist[3]["path_length"] > 0
    f32 = runs["tp"]["history"][0]
    for k in ("loss_discriminator_real", "loss_discriminator_fake", "loss_generator"):
        np.testing.assert_allclose(hist[0][k], f32[k], rtol=2e-2, err_msg=k)


def test_sample_cli_reads_the_tensor_parallel_checkpoints(runs, tmp_path):
    out = tmp_path / "samples"
    done = sample_cli.main(["--checkpoint", str(runs["root"] / "tp" / "models"), "--tiny",
                            "--device", "cpu", "--samples", "2", "--output", str(out)])
    assert done["finite"] and len(os.listdir(out)) > 0


@pytest.mark.parametrize("argv,world", [
    (TP, 2), (TP + ["--devices", "2"], 4),
    (TP + ["--coordinator_address", "h:1", "--num_processes", "4", "--process_id", "3"], 4),
], ids=["default", "devices", "multi-host"])
def test_world_counts_both_axes(argv, world):
    args = train_cli.build_parser().parse_args(["--device", "cpu"] + argv)
    assert train_cli.world_size(args, torch.device("cpu")) == world


@pytest.mark.parametrize("argv,match", [
    (["--model_parallel", "0"], "at least one rank"),
    (TP + ["--devices", "5"], "divide"),
    (TP + ["--coordinator_address", "h:1", "--num_processes", "3", "--process_id", "0"],
     "differs"),
    (TP + ["--coordinator_address", "h:1", "--num_processes", "4", "--process_id", "0",
           "--devices", "4"], "differs"),
], ids=["model_parallel", "batch", "num_processes", "devices"])
def test_a_layout_that_cannot_run_is_refused(argv, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        train_cli.main(["--device", "cpu", "--tiny", "--synthetic", "--batch_size", "24",
                        "--experiment_path", str(tmp_path / "exp")] + argv)
    assert not (tmp_path / "exp").exists()
