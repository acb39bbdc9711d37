"""The port's run-scale tools and the package APIs they use, on the CPU at the
tiny config, held against the JAX package and the JAX tools' records.

* ``make_loader(shuffle=)`` against the JAX ``BatchLoader``
  (pipeline.py:23-33): the same batches in the same order, in one process
  and, as each data rank's rows of the global batch, on two;
* ``Trainer(checkpoint_dir=)`` (JAX loop.py:137, :250-253): checkpoints
  there, restored by another Trainer on another logger;
* the soak's per-step flags over both phases (wrong order, trap weights,
  the cut-mix coin, EMA, lazy R1 and lazy path length) against the JAX
  Trainer's ``_epoch_flags``, ``schedule_coin`` and the global-step cadence
  of JAX loop.py:327-360, for the same epochs, steps per epoch, seed and
  restored step (no JAX model is built);
* ``tools/validation_run.py`` (in this process) and ``tools/soak_b24.py``
  with ``--phase both`` (a launcher process that spawns the two phases, each
  a process of its own, under one time limit; started when this module's
  first test starts, so that it runs beside the others): their records
  with the keys of the JAX records in the repository (``VALIDATION.json``,
  ``SOAK_B24.json``), the soak's resume to the step phase A saved and to
  phase B's resume schedules, the JAX tool's ``--pl_start_tier`` accepted
  and ignored.  The feature nets and the host Frechet
  distance are the cheap stand-ins of ``torch_eval_stubs.py`` (the nets
  and metrics are held against JAX in ``test_torch_port_eval.py``).
"""

import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_eval_stubs
from multi_stylegan_tpu.data.pipeline import BatchLoader
from multi_stylegan_tpu.data.synthetic import SyntheticTLFMDataset as JaxSynthetic
from multi_stylegan_tpu.models.config import TrainingConfig as JaxTrainingConfig
from multi_stylegan_tpu.train.loop import Trainer as JaxTrainer
from multi_stylegan_tpu.train.loop import schedule_coin as jax_schedule_coin
from multi_stylegan_torch.data.pipeline import make_loader
from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset
from multi_stylegan_torch.io.checkpoint import train_state_dict
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.tools import soak_b24, validation_run
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.loop import Trainer, schedule_coin

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 170  # the soak's spawn: a hung phase fails the test, not the suite's clock

LAUNCHER = r"""
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
if __name__ == "__mp_main__":  # each spawned phase
    import json

    import torch
    torch.set_num_threads(1)
    import torch_eval_stubs
    from multi_stylegan_torch.train.loop import Trainer

    torch_eval_stubs.install()
    run_step = Trainer._run_step

    def recording_run_step(self, real, flags, lazy_d, lazy_g):
        with open("flags.jsonl", "a") as f:
            f.write(json.dumps([self.state.step + 1, flags.wrong_order, flags.do_cut_mix]) + "\n")
        return run_step(self, real, flags, lazy_d, lazy_g)

    Trainer._run_step = recording_run_step
if __name__ == "__main__":
    from multi_stylegan_torch.tools import soak_b24
    soak_b24.main({argv!r})
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def soak_process(tmp_path_factory):
    """The soak's launcher process, started before this module's first test
    and killed with its phases if it is still running at the end."""
    root = tmp_path_factory.mktemp("soak")
    argv = ["--tiny", "--device", "cpu", "--dtype", "float32", "--batch", "4", "--epochs", "2",
            "--steps_per_epoch", "4", "--val_samples", "8", "--val_batch", "4",
            "--phase", "both", "--pl_start_tier", "chunked5", "--out", str(root / "soak.json"),
            "--workdir", str(root / "work")]
    launcher = root / "launcher.py"
    launcher.write_text(LAUNCHER.format(repo=str(REPO), tests=str(REPO / "tests"), argv=argv))
    proc = subprocess.Popen([sys.executable, str(launcher)], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    yield root, proc
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)  # the phases too
        proc.communicate()


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_order_matches_jax(shuffle):
    kw = dict(n_samples=10, resolution=(8, 8), seed=2)
    jax_loader = BatchLoader(JaxSynthetic(**kw), 4, shuffle=shuffle, seed=5, num_workers=0)
    loader = make_loader(SyntheticTLFMDataset(**kw), 4, seed=5, shuffle=shuffle)
    assert len(loader) == len(jax_loader) == 2
    for _ in range(2):  # two epochs: the permutation rng carries over
        ours, theirs = list(loader), list(jax_loader)
        assert len(ours) == len(theirs) == 2
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if not shuffle:
        dataset = SyntheticTLFMDataset(**kw)
        np.testing.assert_array_equal(ours[0][1].numpy(), dataset[1])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("rank", [0, 1])
def test_loader_rank_rows_match_jax_process_slices(shuffle, rank, monkeypatch):
    """On two data ranks each rank loads its slice of every global batch, as
    each JAX process does (pipeline.py:87-91), in both orders."""
    kw = dict(n_samples=10, resolution=(8, 8), seed=2)
    theirs = list(BatchLoader(JaxSynthetic(**kw), 4, shuffle=shuffle, seed=5, num_workers=0))
    monkeypatch.setattr(mesh, "world", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: rank)
    ours = list(make_loader(SyntheticTLFMDataset(**kw), 4, seed=5, shuffle=shuffle))
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[2 * rank:2 * rank + 2])


# ------------------------------------------------------------- checkpoints


def _models(seed):
    g, d = Generator(tiny_generator_config()), Discriminator(tiny_discriminator_config())
    g.reset_parameters(torch.Generator().manual_seed(seed))
    d.reset_parameters(torch.Generator().manual_seed(seed + 1))
    return g, d


def _trainer(root, tag, seed=0, checkpoint_dir=None):
    g, d = _models(seed)
    loader = make_loader(SyntheticTLFMDataset(n_samples=16, resolution=g.config.resolution), 4)
    return Trainer(g, d, TrainingConfig(batch_size=4), loader,
                   TorchDraws(torch.Generator().manual_seed(seed)), epochs=1,
                   data_logger=Logger(experiment_path=str(root / tag)),
                   checkpoint_dir=checkpoint_dir)


def test_trainer_checkpoints_into_checkpoint_dir(tmp_path):
    ckpt = tmp_path / "ckpt"
    first = _trainer(tmp_path, "phase_a", checkpoint_dir=str(ckpt))
    first.state.step = 5
    path = first.save_checkpoint()
    assert path.startswith(str(ckpt)) and sorted(p.name for p in ckpt.iterdir()) == [
        "checkpoint_5.pt"]
    assert list((tmp_path / "phase_a" / "models").iterdir()) == []
    second = _trainer(tmp_path, "phase_b", seed=9, checkpoint_dir=str(ckpt))
    assert second.restore_latest() and second.state.step == 5
    saved, restored = (train_state_dict(t.state, full=True) for t in (first, second))

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree]
    pairs = list(zip(leaves(saved), leaves(restored)))
    assert len(pairs) > 100
    for a, b in pairs:
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    # without checkpoint_dir the logger's models/ holds them, as before
    plain = _trainer(tmp_path, "plain")
    assert plain.save_checkpoint().startswith(str(tmp_path / "plain" / "models"))


# ------------------------------------------------------- soak schedules


def jax_flags(cfg, epochs, steps_per_epoch, start_step):
    """Per step of a JAX Trainer run: (step, wrong order, trap, cut-mix,
    EMA, lazy R1, lazy path length), from ``Trainer._epoch_flags`` on a stub
    and the cadence of JAX loop.py:327-360."""
    stub = types.SimpleNamespace(cfg=cfg, epochs=epochs)
    out, step = [], start_step
    for epoch in range(epochs):
        wrong_order, trap, cm_prob = JaxTrainer._epoch_flags(stub, epoch)
        for _ in range(steps_per_epoch):
            step += 1
            lazy_g = step % cfg.lazy_generator_regularization == 0
            out.append((step, bool(wrong_order), bool(trap),
                        jax_schedule_coin(cfg.seed, step) <= cm_prob, not lazy_g,
                        step % cfg.lazy_discriminator_regularization == 0, lazy_g))
    return out


def test_soak_flags_over_both_phases_match_jax(tmp_path):
    """The soak's phases (``soak_b24.phase_config``) at 8 epochs of 4 steps:
    phase A's 4 epochs turn trap weights on at epoch 1, wrong order at 3 and
    the cut-mix probability up by 1/8 an epoch, with the lazy R1 and path
    length at step 16; phase B restores step 16 from the shared directory
    and runs 4 epochs under ``resume_training``, path length at step 32.
    Each step's flags are recorded through a stand-in ``_run_step``."""
    args = types.SimpleNamespace(batch=4, epochs=8, dtype="float32")
    steps_per_epoch, half = 4, 4
    ckpt = str(tmp_path / "ckpt")
    ours = []

    def run(resume, epochs, tag):
        cfg = soak_b24.phase_config(args, resume, epochs)
        trainer = Trainer(*_models(0), cfg,
                          make_loader(SyntheticTLFMDataset(n_samples=args.batch * steps_per_epoch,
                                                           resolution=(32, 32)), args.batch),
                          TorchDraws(torch.Generator().manual_seed(0)), epochs=epochs,
                          data_logger=Logger(experiment_path=str(tmp_path / tag)),
                          checkpoint_dir=ckpt)
        if resume:
            assert trainer.restore_latest()
        start = trainer.state.step

        def run_step(real, flags, lazy_d, lazy_g):
            trainer.state.step += 1
            ours.append((trainer.state.step, flags.wrong_order, flags.trap_weight,
                         flags.do_cut_mix, flags.do_ema, lazy_d, lazy_g))
            return {}
        trainer._run_step = run_step
        trainer.train()
        fields = {f.name for f in dataclasses.fields(JaxTrainingConfig)}
        jax_cfg = JaxTrainingConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                                       if k in fields})
        return start, jax_flags(jax_cfg, epochs, steps_per_epoch, start)

    start_a, jax_a = run(False, half, "phase_a")
    start_b, jax_b = run(True, args.epochs - half, "phase_b")
    assert (start_a, start_b) == (0, half * steps_per_epoch)
    assert ours == jax_a + jax_b
    assert [s for s, *_, lazy_g in ours if lazy_g] == [16, 32]
    cut_mix = [f[3] for f in ours]
    assert any(cut_mix[:16]) and not all(cut_mix[16:]) and any(cut_mix[16:])
    assert [f[1] for f in ours] == [False] * 12 + [True] * 20
    assert [f[2] for f in ours] == [False] * 4 + [True] * 28


# ----------------------------------------------------------- run tools


def test_validation_run_writes_the_jax_record(tmp_path, monkeypatch, capsys):
    torch_eval_stubs.install(monkeypatch.setattr)
    out = tmp_path / "validation.json"
    result = validation_run.main(["--tiny", "--device", "cpu", "--dtype", "float32",
                                  "--samples", "8", "--batch", "4", "--out", str(out),
                                  "--exp_dir", str(tmp_path / "exp")])
    jax_record = json.loads((REPO / "VALIDATION.json").read_text())
    assert json.loads(out.read_text()) == result
    assert set(result) == set(jax_record)
    assert set(result["protocol"]) == set(jax_record["protocol"])
    assert (result["protocol"]["real_samples"], result["protocol"]["fake_samples"]) == (8, 8)
    assert result["protocol"]["batch"] == 4 and result["protocol"]["resolution"] == [32, 32]
    assert set(result["scores"]) == set(jax_record["scores"])
    assert all(math.isfinite(v) for v in result["scores"].values())
    assert set(result["per_metric_wall_s"]) == {"FID", "FVD", "IS"}
    assert all(v > 0 for v in result["per_metric_wall_s"].values())
    assert result["best_fvd_tracked"] == result["scores"]["FVD_bf"]
    assert (result["backend"], result["device"], result["memory_before"]) == ("cpu", "cpu", {})
    split = json.loads(next(line for line in capsys.readouterr().out.splitlines()
                            if line.startswith("split "))[len("split "):])
    assert set(split) == {"generator_sampling", "feature_nets", "frechet_host", "rest"}
    assert sum(split.values()) == pytest.approx(result["total_wall_s"])


@pytest.fixture(scope="module")
def soak(soak_process):
    """The soak's record, phase B's logged metrics, each step's flags and
    the launcher's output, once its process has ended."""
    root, proc = soak_process
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the soak still ran after {TIMEOUT_S} s")
    assert proc.returncode == 0, log[-3000:]
    metrics = {p.stem: np.load(p)
               for p in (root / "work" / "phase_b" / "metrics").glob("*.npy")}
    flags = [json.loads(line) for line in (root / "flags.jsonl").read_text().splitlines()]
    return json.loads((root / "soak.json").read_text()), metrics, flags, log


def test_soak_resumes_in_a_new_process_to_the_full_step_count(soak):
    report, _, _, log = soak
    assert report["ok"], report
    events = {e["event"]: e for e in report["events"]}
    saved = events["latest checkpoint"]["step"]
    assert saved == 4 and events["restored"]["step"] == saved == report["restored_step"]
    assert report["final_step"] == 8 and report["total_steps"] == 8
    assert report["phase_a"]["steps"] == report["phase_b"]["steps"] == 4
    assert "partial" not in report and not report["nan_metrics"]
    assert not report["nonfinite_params"]
    assert not [e for e in report["events"] if "FAILED" in e["event"]]
    for phase in ("phase_a", "phase_b"):  # one reduced validation pass a phase
        assert [e["event"] for e in report["events"] if e["event"].startswith("validation")
                ].count("validation FID") == 2
        assert len(report[phase]["seqs_per_sec"]) == 1
    assert '"phase": "a"' in log and '"ok": true' in log


def test_soak_record_covers_the_jax_record(soak):
    """The TPU record is the JAX tool's partial one, written after phase A;
    a finished run drops ``partial`` and adds phase B's fields (JAX
    tools/soak_b24.py)."""
    report, _, _, _ = soak
    jax_record = json.loads((REPO / "SOAK_B24.json").read_text())
    assert jax_record["partial"] == "phase A complete"
    finished = set(jax_record) - {"partial"} | {"phase_b", "nonfinite_params", "final_step",
                                                 "total_steps"}
    assert finished <= set(report)
    assert set(jax_record["config"]) <= set(report["config"])
    for phase in ("phase_a", "phase_b"):
        assert set(jax_record["phase_a"]) <= set(report[phase])
        assert set(jax_record["phase_a"]["trace"][0]) <= set(report[phase]["trace"][0])


def test_soak_phase_b_runs_the_resume_schedules(soak):
    """Under ``resume_training`` the cut-mix probability is 0.5 and wrong
    order is on from phase B's first step.  The cut-mix loss is logged
    nonzero exactly on the steps whose coin (a function of the seed and the
    step) is at most 0.5, and phase A's one epoch (probability 0) has none;
    wrong order has no metric of its own, so each step's flags come from
    the launcher's record of ``Trainer._run_step``."""
    _, metrics, flags, _ = soak
    assert [f[0] for f in flags] == list(range(1, 9))
    coin = [schedule_coin(0, step) <= 0.5 for step in range(5, 9)]
    assert any(coin) and not all(coin)
    assert [bool(v != 0) for v in metrics["loss_cut_mix_augmentation"]] == coin
    assert [f[2] for f in flags] == [False] * 4 + coin
    assert [f[1] for f in flags] == [False] * 4 + [True] * 4


def test_soak_accepts_and_ignores_the_jax_start_tier(soak):
    """``--pl_start_tier chunked5`` (the TPU soak's, full chunking at b24)
    is accepted and each phase's ladder starts unchunked all the same."""
    report, _, _, _ = soak
    assert "ignored" in soak_b24.build_parser().format_help()
    ignored = [e for e in report["events"] if e["event"].endswith("pl start tier ignored")]
    assert [(e["event"], e["tier"], e["chunks"]) for e in ignored] == [
        ("phase_a pl start tier ignored", "chunked5", 1),
        ("phase_b pl start tier ignored", "chunked5", 1)]
