"""The training CLI with data-parallel ranks on the CPU (tiny configs):
``--devices 2 --device cpu`` spawns two gloo ranks (two spawns in this
module: a 2-epoch run, then a resume of its first checkpoint), held against
one process at the same global batch; plus the layout arithmetic and the
writer rule in one process.

``--resume_training`` turns wrong order and cut-mix on from the first step
and keeps every step's flags a function of (seed, step), so the resumed
epoch runs the flags of the uninterrupted run's second epoch.  The
synthetic fixture has no flips.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from multi_stylegan_torch.cli import train as train_cli
from multi_stylegan_torch.data.pipeline import EpochSampler
from multi_stylegan_torch.io.checkpoint import read_checkpoint
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.models.config import TrainingConfig
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.loop import Trainer

BATCH = 16  # global: 8 rows a rank; 64 fixture sequences make 4 steps an epoch
BASE = ["--tiny", "--synthetic", "--device", "cpu", "--batch_size", str(BATCH), "--seed", "3",
        "--resume_training"]
EVERY_EPOCH = {"checkpoint_every_n_epochs": 1}
LOSSES = ("loss_discriminator_real", "loss_discriminator_fake", "loss_generator",
          "loss_cut_mix_augmentation", "loss_discriminator_real_pixel_wise", "ada_r")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, and so in each spawned rank (the CLI gives its
    CPU ranks this process's threads shared out): the suite runs several
    workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _main_capturing(log, argv, **kw):
    """``cli.train.main`` with file descriptor 1 (the spawned ranks' too)
    sent to ``log``."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(log, "w") as f:
            os.dup2(f.fileno(), 1)
            return train_cli.main(argv, **kw)
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_cli")
    two = _main_capturing(root / "two.log", BASE + [
        "--devices", "2", "--epochs", "2", "--experiment_path", str(root / "two")],
        config_overrides=EVERY_EPOCH)
    resumed = _main_capturing(root / "resumed.log", BASE + [
        "--devices", "2", "--epochs", "1", "--experiment_path", str(root / "resumed"),
        "--load_checkpoint", str(root / "two" / "models" / "checkpoint_4.pt")],
        config_overrides=EVERY_EPOCH)
    one = train_cli.main(BASE + ["--epochs", "1", "--experiment_path", str(root / "one")])
    return {"root": root, "two": two, "resumed": resumed, "one": one}


def test_cli_two_ranks_one_writer(runs):
    root = runs["root"]
    log = (root / "two.log").read_text()
    assert runs["two"]["steps"] == 8 and runs["two"]["finite"]
    assert log.count("Start training") == 1 and log.count("2 rank(s)") == 1
    assert [log.count(f"step {s}:") for s in range(1, 9)] == [1] * 8
    exp = root / "two"
    assert sorted(os.listdir(exp / "models")) == ["checkpoint_4.pt", "checkpoint_8.pt"]
    assert len(np.load(exp / "metrics" / "loss_generator.npy")) == 8
    assert (exp / "metrics" / "eta.log").read_text().count("epoch") == 2
    assert len(read_checkpoint(str(exp / "models"))["loader"]) == 2  # both ranks' loaders


def test_cli_two_ranks_same_batches_as_one_process(runs):
    """The two ranks' first epoch against one process at the same global
    batch: the same batches, draws, wrong-order rows and cut-mix steps give
    the same losses up to the order of the sums (the parameters drift apart
    by that rounding, step by step)."""
    one, two = runs["one"]["history"], runs["two"]["history"][:4]
    assert len(one) == 4
    for step, (a, b) in enumerate(zip(one, two), start=1):
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4 * step, atol=1e-6,
                                       err_msg=f"step {step} {k}")


def test_cli_two_ranks_resume_is_bitwise(runs):
    root = runs["root"]
    assert runs["resumed"]["history"] == [
        {**m, "seconds": r["seconds"], "data_wait_seconds": r["data_wait_seconds"]}
        for m, r in zip(runs["two"]["history"][4:], runs["resumed"]["history"])]
    a = read_checkpoint(str(root / "two" / "models" / "checkpoint_8.pt"))
    b = read_checkpoint(str(root / "resumed" / "models" / "checkpoint_8.pt"))
    flat_a, flat_b = mesh.tensors_of(a["train_state"]), mesh.tensors_of(b["train_state"])
    assert len(flat_a) == len(flat_b) > 100
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    assert a["loader"] == b["loader"] and torch.equal(a["draws"], b["draws"])


# ------------------------------------------------------ one process


def test_each_rank_loads_its_slice_of_every_global_batch():
    """The ranks' samplers, batched by the local batch, concatenate to the
    one-process batches of the same seed (drop-last over global batches)."""
    n, batch, world = 37, 8, 2
    one = list(EpochSampler(n, seed=5))
    ranks = [list(EpochSampler(n, seed=5, batch_size=batch, rank=r, world=world))
             for r in range(world)]
    per = batch // world
    assert [len(r) for r in ranks] == [n // batch * per] * world
    for i in range(n // batch):
        assert sum((r[i * per:(i + 1) * per] for r in ranks), []) == one[i * batch:(i + 1) * batch]


@pytest.mark.parametrize("argv,world", [
    ([], 1), (["--devices", "4"], 4),
    (["--coordinator_address", "localhost:1", "--num_processes", "3", "--process_id", "2",
      "--batch_size", "6"], 3),
], ids=["default", "devices", "multi-host"])
def test_world_size_from_the_flags(argv, world):
    args = train_cli.build_parser().parse_args(["--device", "cpu"] + argv)
    assert train_cli.world_size(args, torch.device("cpu")) == world


@pytest.mark.parametrize("argv,match", [
    (["--devices", "5"], "divide"),
    (["--coordinator_address", "h:1", "--num_processes", "2", "--process_id", "2"], "outside"),
    (["--coordinator_address", "h:1", "--num_processes", "2", "--process_id", "0",
      "--devices", "4"], "differs"),
], ids=["batch", "process_id", "devices"])
def test_world_size_refuses_a_layout_it_cannot_run(argv, match):
    args = train_cli.build_parser().parse_args(["--device", "cpu", "--batch_size", "24"] + argv)
    with pytest.raises(ValueError, match=match):
        train_cli.world_size(args, torch.device("cpu"))


@pytest.mark.parametrize("batch,world,what", [(10, 4, "training batch 10")])
def test_uneven_shards_are_refused_before_training(batch, world, what, monkeypatch):
    """Only a training batch that does not divide over the data ranks (the
    JAX mesh refuses it too)."""
    from multi_stylegan_torch.train.steps import TrainStep

    monkeypatch.setattr(mesh, "world", lambda: world)
    with pytest.raises(ValueError, match=what):
        TrainStep(TrainingConfig(batch_size=batch)).check_shards(batch)


@pytest.mark.parametrize("batch,world", [(24, 4), (6, 2), (24, 8), (12, 4)],
                         ids=["wrong-order-6-over-4", "path-length-3-over-2",
                              "both-over-8", "wrong-order-3-over-4"])
def test_uneven_sub_batches_are_accepted(batch, world, monkeypatch):
    """The wrong-order and path-length rows may fall unevenly (at batch 24:
    6 and 12 rows over 4 or 8 data ranks); the CLI accepts the layout."""
    from multi_stylegan_torch.train.steps import TrainStep

    monkeypatch.setattr(mesh, "world", lambda: world)
    TrainStep(TrainingConfig(batch_size=batch)).check_shards(batch)
    args = train_cli.build_parser().parse_args(
        ["--device", "cpu", "--batch_size", str(batch), "--devices", str(world)])
    assert train_cli.world_size(args, torch.device("cpu")) == world


def test_a_rank_other_than_zero_writes_nothing(tmp_path, monkeypatch):
    """A trainer on rank 1 trains, validates and checkpoints like rank 0 but
    writes no metric, grid, ETA line or checkpoint (at world size 1 here:
    the writer rule alone)."""
    from multi_stylegan_torch.data.pipeline import make_loader

    monkeypatch.setattr(mesh, "rank", lambda: 1)
    args = train_cli.build_parser().parse_args(["--tiny", "--synthetic", "--batch_size", "16"])
    g, d, cfg, dataset = train_cli.build(args, torch.device("cpu"))
    logger = Logger(experiment_path=str(tmp_path / "exp"))
    before = sorted(str(p) for p in tmp_path.rglob("*"))
    trainer = Trainer(g, d, TrainingConfig(batch_size=16, checkpoint_every_n_epochs=1),
                      make_loader(dataset, 16, seed=0), TorchDraws(torch.Generator().manual_seed(0)),
                      epochs=1, data_logger=logger)
    history = trainer.train()
    assert len(history) == 4 and all(math.isfinite(v) for v in history[-1].values())
    assert trainer.save_checkpoint() is None
    assert sorted(str(p) for p in tmp_path.rglob("*")) == before
