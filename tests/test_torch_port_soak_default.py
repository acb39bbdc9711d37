"""How many data ranks the soak (tools/soak_b24.py) and the training CLI
(cli/train.py::world_size) run on, by the one rule of
parallel/mesh.py::data_ranks: ``--devices`` when given, else every visible
card under ``--device cuda`` (the JAX soak's ``make_mesh()`` puts every
device on the data axis), else one rank; a global batch that does not
divide over them is refused before anything is written.  The visible cards
are patched (``torch.cuda.device_count``); nothing is spawned.  Then
which phase's Trainer the soak's ``--profile_dir`` reaches."""

import os

import pytest
import torch

from multi_stylegan_torch.cli import train as train_cli
from multi_stylegan_torch.tools import soak_b24

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (device, visible cards, batch, --devices or None, data ranks or None = refused)
CASES = {
    "cpu-default": ("cpu", 4, 24, None, 1),
    "cuda-4-cards": ("cuda", 4, 24, None, 4),
    "cuda-8-cards-b24": ("cuda", 8, 24, None, 8),
    "cuda-1-card": ("cuda", 1, 24, None, 1),
    "cuda-N-one-rank": ("cuda:1", 4, 24, None, 1),
    "cuda-5-cards-b24-refused": ("cuda", 5, 24, None, None),
    "cuda-7-cards-b24-refused": ("cuda", 7, 24, None, None),
    "explicit-2-wins-cuda": ("cuda", 4, 24, 2, 2),
    "explicit-2-wins-cpu": ("cpu", 4, 24, 2, 2),
    "explicit-5-refused": ("cpu", 4, 24, 5, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_data_ranks_default_to_every_visible_card(case, tmp_path, monkeypatch):
    device, cards, batch, devices, want = CASES[case]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    flags = ["--device", device] + ([] if devices is None else ["--devices", str(devices)])
    soak_args = soak_b24.build_parser().parse_args(flags + ["--batch", str(batch)])
    cli_args = train_cli.build_parser().parse_args(flags + ["--batch_size", str(batch)])
    assert soak_args.devices is None if devices is None else soak_args.devices == devices
    if want is not None:
        assert soak_b24.data_ranks(soak_args, torch.device(device)) == want
        assert train_cli.world_size(cli_args, torch.device(device)) == want
        return
    with pytest.raises(ValueError, match="--batch 24 is the global batch and must divide"):
        soak_b24.data_ranks(soak_args, torch.device(device))
    with pytest.raises(ValueError, match="--batch_size 24 is the global batch and must divide"):
        train_cli.world_size(cli_args, torch.device(device))
    # the tool and the CLI refuse before writing a record, a workdir or an experiment
    out, work, exp = (str(tmp_path / n) for n in ("soak.json", "work", "exp"))
    with pytest.raises(ValueError, match="must divide"):
        soak_b24.main(flags + ["--batch", str(batch), "--out", out, "--workdir", work])
    with pytest.raises(ValueError, match="must divide"):
        train_cli.main(flags + ["--batch_size", str(batch), "--synthetic", "--tiny",
                                "--experiment_path", exp])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("phase,traced", [("a", True), ("b", False)])
def test_soak_traces_phase_a_only(phase, traced, tmp_path, monkeypatch):
    """``--profile_dir`` reaches phase A's Trainer (its window: steps 2-5)
    and not phase B's, whose steps start after the window."""
    from multi_stylegan_torch.train import loop

    seen = {}

    class Stop(Exception):
        pass

    def trainer(*args, profile_dir=None, **kw):
        seen["profile_dir"] = profile_dir
        raise Stop

    monkeypatch.setattr(loop, "Trainer", trainer)
    args = soak_b24.build_parser().parse_args(
        ["--tiny", "--device", "cpu", "--dtype", "float32", "--batch", "4", "--epochs", "2",
         "--steps_per_epoch", "1", "--phase", phase, "--profile_dir", str(tmp_path / "prof"),
         "--out", str(tmp_path / "soak.json"), "--workdir", str(tmp_path / "work")])
    with pytest.raises(Stop):
        soak_b24.run_phase(torch.device("cpu"), args)
    assert seen["profile_dir"] == (str(tmp_path / "prof") if traced else None)
