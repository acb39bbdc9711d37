"""A path-length update that every tier of the out-of-memory ladder failed
(train/robust.py) leaves the state as the JAX Trainer leaves it: the JAX
ladder returns its state unchanged (multi_stylegan_tpu/train/robust.py,
the excluded path), after a main step that skipped the EMA because the
path-length update was due (multi_stylegan_tpu/train/loop.py, ``do_ema =
not lazy_g``).  So the G parameters, the running mean and the EMA stay as
they were.  Tiny configs on the CPU, the failure injected as
``torch.cuda.OutOfMemoryError``.
"""

import warnings

import pytest
import torch

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
from multi_stylegan_torch.train.robust import RobustPathLength
from multi_stylegan_torch.train.state import create_train_state
from multi_stylegan_torch.train.steps import TrainStep


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on a few
    cores, and more threads only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(batch):
    g, d = Generator(tiny_generator_config()), Discriminator(tiny_discriminator_config())
    g.reset_parameters(torch.Generator().manual_seed(0))
    d.reset_parameters(torch.Generator().manual_seed(1))
    cfg = TrainingConfig(batch_size=batch)
    state = create_train_state(g, d, cfg)
    with torch.no_grad():  # an EMA apart from G, so that an EMA update would show
        for p in state.g_ema.parameters():
            p.add_(0.1)
    state.mean_path_length = torch.tensor(0.03)
    return state, TrainStep(cfg)


def _out_of_memory(state, pld, n_chunks=1):
    raise torch.cuda.OutOfMemoryError(f"CUDA out of memory at {n_chunks} chunk(s)")


def _snapshot(state):
    return {"g": [p.detach().clone() for p in state.generator.parameters()],
            "g_ema": [p.detach().clone() for p in state.g_ema.parameters()],
            "mean": state.mean_path_length.clone()}


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_skipped_update_leaves_g_the_running_mean_and_the_ema_bitwise():
    state, ts = _state(8)
    ts.path_length_grads = _out_of_memory
    ladder = RobustPathLength(ts, report=lambda m: None)
    before = _snapshot(state)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pen, pl, metrics = ladder(state, TorchDraws(torch.Generator().manual_seed(2)))
    assert any("DISABLED" in str(w.message) for w in caught)
    assert float(metrics["path_length_skipped"]) == 1 and float(metrics["path_length_chunks"]) == 0
    assert float(pen) == 0 and float(pl) == 0
    after = _snapshot(state)
    assert _same(before["g"], after["g"])
    assert _same(before["g_ema"], after["g_ema"])
    assert torch.equal(before["mean"], after["mean"])


def test_trainer_step_with_a_skipped_update_applies_no_ema(tmp_path, monkeypatch):
    """Through the Trainer at lazy interval 2: step 2's main step runs
    without the EMA (the update is due) and the update is skipped, so the
    EMA after step 2 is the EMA after step 1, while G moved."""
    monkeypatch.setattr(TrainStep, "path_length_grads",
                        lambda self, state, pld, n_chunks=1: _out_of_memory(state, pld, n_chunks))
    state, _ = _state(4)
    seen = []
    main_step = TrainStep.main_step

    def recording_main_step(self, state, real, flags, draws):
        seen.append((bool(flags.do_ema), _snapshot(state)))
        return main_step(self, state, real, flags, draws)
    monkeypatch.setattr(TrainStep, "main_step", recording_main_step)
    cfg = TrainingConfig(batch_size=4, lazy_generator_regularization=2)
    loader = make_loader(SyntheticTLFMDataset(n_samples=8, resolution=(32, 32)), 4)
    trainer = Trainer(state.generator, state.discriminator, cfg, loader,
                      TorchDraws(torch.Generator().manual_seed(0)), epochs=1,
                      data_logger=Logger(experiment_path=str(tmp_path / "exp")))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        hist = trainer.train()
    assert [m["path_length_skipped"] for m in hist] == [0, 1]
    assert [do_ema for do_ema, _ in seen] == [True, False]
    after_step_1, end = seen[1][1], _snapshot(trainer.state)
    assert _same(after_step_1["g_ema"], end["g_ema"])
    assert torch.equal(after_step_1["mean"], end["mean"])
    assert not _same(after_step_1["g"], end["g"])
