"""The CLIs pin the port's f32 precision (utils/precision.py): TF32 off in
cuDNN's convolutions and cuBLAS's matmuls, before any model is built, so
their f32 is the f32 the parity checks hold.  Each CLI runs here at the tiny
config on the CPU on its smallest input, from flags set to True."""

import pytest
import torch

from multi_stylegan_torch.cli import interpolate, sample, train
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.utils.precision import pin_f32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on a few
    cores, and more threads only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


CLIS = {
    "sample": lambda tmp: sample.main(["--tiny", "--device", "cpu", "--samples", "1",
                                       "--batch_size", "1", "--output", str(tmp / "s")]),
    "interpolate": lambda tmp: interpolate.main(
        ["--tiny", "--device", "cpu", "--frames", "2", "--anchors", "2", "--batch_size", "2",
         "--output", str(tmp / "i")]),
    "train": lambda tmp: train.main(
        ["--synthetic", "--tiny", "--device", "cpu", "--epochs", "1", "--batch_size", "16",
         "--no_validation_metrics", "--experiment_path", str(tmp / "e")]),
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_pins_tf32_off_before_building_a_model(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert _flags() == (True, True)
    at_build = []
    init = Generator.__init__

    def recording_init(self, *a, **kw):
        at_build.append(_flags())
        init(self, *a, **kw)
    monkeypatch.setattr(Generator, "__init__", recording_init)
    CLIS[cli](tmp_path)
    assert at_build and set(at_build) == {(False, False)}
    assert _flags() == (False, False)


def test_pin_f32_sets_both_flags(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    pin_f32()
    assert _flags() == (False, False)
