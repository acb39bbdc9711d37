"""The soak tool (``tools/soak_b24.py``) over two data ranks on the CPU, as
the JAX tool trains both phases on ``make_mesh()`` (every device of the host
on the data axis): ``--devices 2`` at the tiny config, two gloo ranks a
phase, started through the training CLI's launcher
(``parallel/mesh.py::spawn``), phase B's ranks new processes restoring phase
A's checkpoint, held against the same soak on one rank.  A launcher
process runs each soak under its own time limit, both started when this
module's first test starts; its top level installs the stand-in nets and
Frechet distance of ``torch_eval_stubs.py`` and one torch thread, so every
spawned rank gets them too.  2 epochs of 8 steps at batch 4 (2 rows a
rank): phase B ends at step 16, where R1 and path length run.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from multi_stylegan_torch.io.checkpoint import read_checkpoint

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 170  # both phases' spawns: a hung rank fails the test, not the suite's clock

LAUNCHER = r"""
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import torch
torch.set_num_threads(1)  # the launcher's threads are shared out over the CPU ranks
import torch_eval_stubs
torch_eval_stubs.install()
if __name__ == "__main__":
    from multi_stylegan_torch.tools import soak_b24
    soak_b24.main({argv!r})
"""


def _launch(root: Path, devices: int) -> subprocess.Popen:
    argv = ["--tiny", "--device", "cpu", "--dtype", "float32", "--devices", str(devices),
            "--batch", "4", "--epochs", "2", "--steps_per_epoch", "8", "--val_samples", "8",
            "--val_batch", "4", "--phase", "both", "--out", str(root / "soak.json"),
            "--workdir", str(root / "work")]
    launcher = root / "launcher.py"
    launcher.write_text(LAUNCHER.format(repo=str(REPO), tests=str(REPO / "tests"), argv=argv))
    return subprocess.Popen([sys.executable, str(launcher)], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


@pytest.fixture(autouse=True, scope="module")
def soak_processes(tmp_path_factory):
    """The soak's launcher processes on two ranks and on one with the same
    arguments, both started before this module's first test and killed with
    their ranks if still running at the end."""
    runs = {n: (root, _launch(root, n))
            for n in (2, 1) for root in [tmp_path_factory.mktemp(f"soak_{n}_ranks")]}
    yield runs
    for _, proc in runs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)  # the ranks too
            proc.communicate()


def _finished(root: Path, proc: subprocess.Popen):
    """The record, each phase's logged metrics, the checkpoints and the
    launcher's output, once its process has ended."""
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the soak still ran after {TIMEOUT_S} s")
    assert proc.returncode == 0, log[-3000:]
    metrics = {phase: {p.stem: np.load(p) for p in (root / "work" / phase / "metrics").glob("*.npy")}
               for phase in ("phase_a", "phase_b")}
    return json.loads((root / "soak.json").read_text()), metrics, root / "work" / "ckpt", log


@pytest.fixture(scope="module")
def soak(soak_processes):
    """The two ranks' run: see :func:`_finished`."""
    return _finished(*soak_processes[2])


@pytest.fixture(scope="module")
def soak_one_rank(soak_processes):
    """The same soak on one rank."""
    return _finished(*soak_processes[1])


def test_two_ranks_resume_on_every_rank_to_the_full_step_count(soak):
    report, _, ckpt, log = soak
    assert report["ok"], report
    assert (report["data_ranks"], report["backend"]) == (2, "gloo")
    events = {e["event"]: e for e in report["events"]}
    saved = events["latest checkpoint"]["step"]
    assert saved == 8 and report["restored_step_by_rank"] == [saved, saved]
    assert report["restored_step"] == events["restored"]["step"] == saved
    assert report["phase_a"]["steps"] == report["phase_b"]["steps"] == 8
    assert report["final_step"] == saved + report["phase_b"]["steps"] == 16
    assert report["total_steps"] == 16 and "partial" not in report
    assert not report["nan_metrics"] and not report["nonfinite_params"]
    assert report["nonfinite_params_by_rank"] == [0, 0]
    assert not [e for e in report["events"] if "FAILED" in e["event"]]
    # one writer: one phase line, one record, every rank's loader state saved
    assert log.count('"phase": "a"') == 1 and log.count('"ok": true') == 1
    assert sorted(p.name for p in ckpt.iterdir()) == ["checkpoint_16.pt", "checkpoint_8.pt"]
    assert len(read_checkpoint(str(ckpt / "checkpoint_16.pt"))["loader"]) == 2


def test_two_ranks_record_covers_the_jax_record_and_the_ranks(soak):
    report, _, _, _ = soak
    jax_record = json.loads((REPO / "SOAK_B24.json").read_text())
    finished = set(jax_record) - {"partial"} | {"phase_b", "nonfinite_params", "final_step",
                                                 "total_steps"}
    assert finished | {"data_ranks", "backend", "restored_step", "restored_step_by_rank",
                       "nonfinite_params_by_rank"} <= set(report)
    assert report["device"] == "cpu"
    for phase in ("phase_a", "phase_b"):
        assert set(jax_record["phase_a"]) | {"peak_memory_bytes", "peak_memory_bytes_by_rank",
                                             "fixture_sha256"} <= set(report[phase])
        assert report[phase]["peak_memory_bytes_by_rank"] == [None, None]  # no card
        # the global batch's sequences an epoch, not one rank's
        assert len(report[phase]["seqs_per_sec"]) == 1 and report[phase]["seqs_per_sec"][0] > 0


def test_two_ranks_share_one_teacher_fixture(soak):
    """Rank 0 draws the fixture and broadcasts it; every rank's digest must
    agree or the phase fails.  Both phases draw the same samples."""
    report, _, _, _ = soak
    digests = {report[phase]["fixture_sha256"] for phase in ("phase_a", "phase_b")}
    assert len(digests) == 1 and len(digests.pop()) == 64


def test_two_ranks_regularise_on_the_cadence_only(soak):
    """Phase B (steps 9-16) runs R1 and path length at step 16 alone (both
    come every 16 global steps), and validates once, as phase A does."""
    report, metrics, _, _ = soak
    for name in ("loss_discriminator_regularization", "path_length"):
        assert len(metrics["phase_b"][name]) == 8
        assert [i + 9 for i, v in enumerate(metrics["phase_b"][name]) if v != 0] == [16], name
    validated = [e["event"] for e in report["events"] if e["event"].startswith("validation")]
    assert validated == ["validation FID", "validation FVD", "validation IS"] * 2


def test_two_ranks_train_as_one_rank_at_the_global_batch(soak, soak_one_rank):
    """The two ranks against one process with the same arguments: the same
    fixture, batches and draws (each rank its rows of them) give the same
    logged losses and ADA statistics in both phases, up to the order of the
    sums, as in test_torch_port_ddp_cli.py (the parameters drift apart by
    that rounding, step by step), and the same validation scores."""
    report, metrics, _, _ = soak
    one_report, one_metrics, _, _ = soak_one_rank
    assert one_report["ok"] and one_report["data_ranks"] == 1
    for phase in ("phase_a", "phase_b"):
        assert report[phase]["fixture_sha256"] == one_report[phase]["fixture_sha256"]
        names = sorted(set(one_metrics[phase]) - {"seqs_per_sec", "seconds",
                                                   "data_wait_seconds"})
        assert set(names) <= set(metrics[phase]) and "loss_generator" in names
        last = 8 if phase == "phase_a" else 16
        for name in names:
            a, b = one_metrics[phase][name], metrics[phase][name]
            assert a.shape == b.shape and a.shape in ((8,), (1,)), name
            steps = np.arange(last - len(a) + 1, last + 1)  # a validation score: the end's
            for step, x, y in zip(steps, a, b):
                np.testing.assert_allclose(y, x, rtol=1e-4 * step, atol=1e-6,
                                           err_msg=f"{phase} step {step} {name}")
