"""The PyTorch port's trainer around the step (CPU, tiny configs): the CLI
on a TLFM TIFF tree, exact resume, rolling checkpoints, the epoch schedules
and the flags that are not ported (trap weights in the step:
test_torch_port_trap.py)."""

import json
import os

import numpy as np
import pytest
import torch

from multi_stylegan_tpu.io.logger import Logger as JaxLogger
from multi_stylegan_torch.cli import train as train_cli
from multi_stylegan_torch.data.pipeline import make_loader
from multi_stylegan_torch.data.tlfm import TLFMDataset, write_tlfm_tree
from multi_stylegan_torch.data.trap_weights import make_trap_weights_map
from multi_stylegan_torch.eval.i3d import InceptionI3D
from multi_stylegan_torch.eval.inception_v3 import InceptionV3
from multi_stylegan_torch.io.checkpoint import train_state_dict
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.loop import Trainer, top_k_iterations
from test_torch_port_eval import _frechet_low_rank

TRAP = make_trap_weights_map((32, 32), inside_weight=4.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """12 sequences (2 traps x 4 timesteps x 3 z), written by cv2 with its
    default LZW + predictor compression."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("tlfm_trainer")
    write_tlfm_tree(str(root), n_traps=2, n_times=4)
    for name in os.listdir(root / "Pos0"):
        path = str(root / "Pos0" / name)
        img = cv2.imread(path, -1)
        os.remove(path)
        cv2.imwrite(path, img)
    return str(root)


def test_cli_trains_on_a_tlfm_tree_and_writes_the_experiment(tree, tmp_path, monkeypatch):
    """2 epochs of 3 steps with trap weights and metric weights given: the
    logger's files are the ones the JAX Logger writes for the same streams."""
    from multi_stylegan_torch.eval import metrics

    torch.save(InceptionV3().state_dict(), tmp_path / "inception.pt")
    torch.save(InceptionI3D().state_dict(), tmp_path / "i3d.pt")
    monkeypatch.setenv("MSG_TPU_INCEPTION_PT", str(tmp_path / "inception.pt"))
    monkeypatch.setenv("MSG_TPU_I3D_PT", str(tmp_path / "i3d.pt"))
    # scipy's sqrtm of 2048 x 2048 takes ~15 s here; test_torch_port_eval.py
    # holds this stand-in equal to it
    monkeypatch.setattr(metrics, "frechet_distance", _frechet_low_rank)
    exp = tmp_path / "exp"
    run = train_cli.main(["--tiny", "--device", "cpu", "--path_to_data", tree, "--trap_weights",
                          "--epochs", "2", "--batch_size", "4", "--seed", "1",
                          "--experiment_path", str(exp)],
                         config_overrides=dict(checkpoint_every_n_epochs=1,
                                               validate_every_n_epochs=2),
                         validation_samples=4)
    assert run["steps"] == 6 and run["finite"] and run["state"].step == 6
    logger = run["trainer"].logger
    assert sorted(os.listdir(exp)) == ["hyperparameters", "metrics", "models", "plots"]
    assert sorted(os.listdir(exp / "models")) == ["checkpoint_3.pt", "checkpoint_6.pt"]
    for name in ("FID", "FVD", "IS"):
        for ch in ("bf", "gfp"):
            values = np.load(exp / "metrics" / f"{name}_{ch}.npy")
            assert values.shape == (1,) and np.isfinite(values).all()
    hyper = json.loads((exp / "hyperparameters" / "hyperparameter.txt").read_text())
    assert hyper["trap_weights"] == ["True"] and hyper["epochs"] == ["2"]
    # the JAX Logger, fed the same streams and predictions, names the same files
    ref = JaxLogger(experiment_path=str(tmp_path / "jax"))
    ref.hyperparameters = logger.hyperparameters
    for name, values in logger.metrics.items():
        for v in values:
            ref.log_metric(name, v)
        once = name.split("_")[0] in ("FID", "FVD", "IS")  # one validation, at epoch 2
        assert len(values) == (2 if name == "seqs_per_sec" else 1 if once else 6), name
    ref.save()
    pred = np.zeros((15, 2, 3, 4, 4), np.float32)
    for epoch in (1, 2):
        for tag in ("prediction_ema", "prediction"):
            ref.save_prediction(pred, f"{tag}_{epoch}")
            ref.save_prediction(pred, f"{tag}_rand_{epoch}")
    for sub in ("metrics", "hyperparameters", "plots"):
        ours = sorted(f for f in os.listdir(exp / sub) if f != "eta.log")
        assert ours == sorted(os.listdir(tmp_path / "jax" / sub)), sub
    assert len(os.listdir(exp / "plots")) == 2 * 4 * 15 * 2
    assert (exp / "metrics" / "eta.log").read_text().count("epoch") == 2
    # trap weights from epoch 1 on (trap_weight_start 0.25 x 2 epochs = 0.5)
    assert np.isfinite(np.load(exp / "metrics" / "loss_discriminator_real_pixel_wise.npy")).all()


@pytest.mark.parametrize("argv", [
    ["--devices", "2"], ["--model_parallel", "0"], ["--coordinator_address", "localhost:1234"],
    ["--num_processes", "2", "--process_id", "0"],
], ids=lambda a: a[0])
def test_unported_flags_raise(argv, tmp_path):
    """Every flag is ported: the data- and model-parallel flags are held in
    tests/test_torch_port_ddp*.py and tests/test_torch_port_tp*.py.  A
    layout they cannot run raises before anything is written: a global batch
    that the data ranks do not divide, a model axis below one rank, part of
    the multi-host flags without the rest."""
    error, match = {"--model_parallel": (ValueError, "at least one rank"),
                    "--devices": (ValueError, "divide")}.get(argv[0], (ValueError, "go together"))
    with pytest.raises(error, match=match):
        train_cli.main(["--tiny", "--synthetic", "--device", "cpu", "--batch_size", "5",
                        "--experiment_path", str(tmp_path)] + argv)
    assert not os.listdir(tmp_path)  # refused before anything was written


@pytest.mark.parametrize("argv", [
    ["--dtype", "bfloat16"], ["--ada_sequential_warps"], ["--load_checkpoint", "reference.pt"],
], ids=lambda a: a[0])
def test_ported_flags_are_not_refused(argv):
    """bf16 training, the sequential warps and a reference .pt in
    --load_checkpoint are ported (held against the JAX package in
    test_torch_port_{bf16,fft_ada,reference_ckpt}.py): the CLI takes them."""
    args = train_cli.build_parser().parse_args(["--device", "cpu"] + argv)
    assert train_cli.world_size(args, torch.device("cpu")) == 1


def test_tpu_choices_are_accepted_and_ignored():
    args = train_cli.build_parser().parse_args(["--ada_warp_fwd", "matmul", "--platform", "tpu",
                                                "--device", "cpu"])
    assert train_cli.world_size(args, torch.device("cpu")) == 1
    assert "ignored" in train_cli.build_parser().format_help()


# ------------------------------------------------------------------ resume


def _trainer(tree, exp, seed=2):
    gcfg, dcfg = tiny_generator_config(), tiny_discriminator_config()
    init = torch.Generator().manual_seed(seed)
    g, d = Generator(gcfg), Discriminator(dcfg)
    g.reset_parameters(init)
    d.reset_parameters(init)
    cfg = TrainingConfig(batch_size=4, seed=seed, checkpoint_every_n_epochs=1,
                         validate_every_n_epochs=100)
    loader = make_loader(TLFMDataset(tree, no_rfp=True), 4, seed=seed)
    return Trainer(g, d, cfg, loader, TorchDraws(torch.Generator().manual_seed(seed)), epochs=1,
                   data_logger=Logger(experiment_path=str(exp)), trap_weights_map=TRAP)


def _everything(trainer):
    """Every tensor and rng state a resumed run depends on, as host copies."""
    flat = {}

    def visit(prefix, value):
        if isinstance(value, dict):
            for k, v in value.items():
                visit(f"{prefix}.{k}", v)
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                visit(f"{prefix}.{i}", v)
        elif isinstance(value, torch.Tensor):
            flat[prefix] = value.detach().clone()
        else:
            flat[prefix] = value

    visit("state", train_state_dict(trainer.state))
    flat["draws"] = trainer.draws.generator.get_state().clone()
    flat["sampler"] = trainer.loader.sampler.rng.bit_generator.state
    flat["flips"] = trainer.loader.dataset.rng.bit_generator.state
    return flat


def _assert_identical(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_resume_is_exact(tree, tmp_path):
    """One epoch, checkpoint, then: the uninterrupted trainer's next epoch
    equals a fresh trainer's restored from the file, bitwise."""
    first = _trainer(tree, tmp_path / "a")
    first.train()
    saved = _everything(first)
    assert first.ckpt.latest_step() == 3

    resumed = _trainer(tree, tmp_path / "b", seed=7)  # other weights, draws and order
    assert resumed.restore_latest(first.ckpt.root)
    _assert_identical(_everything(resumed), saved)

    h_first, h_resumed = first.train(), resumed.train()
    assert [m["loss_generator"] for m in h_first] == [m["loss_generator"] for m in h_resumed]
    for a, b in zip(h_first, h_resumed):
        assert {k: v for k, v in a.items() if "seconds" not in k} == \
               {k: v for k, v in b.items() if "seconds" not in k}
    _assert_identical(_everything(resumed), _everything(first))
    assert resumed.state.step == 6 and resumed.ckpt.latest_step() == 6


def test_checkpoints_roll_and_replace_atomically(tree, tmp_path, monkeypatch):
    trainer = _trainer(tree, tmp_path / "exp")
    for step in range(1, 8):
        trainer.state.step = step
        trainer.save_checkpoint()
    assert trainer.ckpt.steps() == [3, 4, 5, 6, 7]
    assert not [f for f in os.listdir(trainer.ckpt.root) if ".tmp" in f]

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    trainer.state.step = 8
    with pytest.warns(RuntimeWarning, match="checkpoint save failed at epoch 1"):
        trainer._guarded(trainer.save_checkpoint, 0, "checkpoint save", "training continues")
    assert trainer.ckpt.steps() == [3, 4, 5, 6, 7]
    assert not [f for f in os.listdir(trainer.ckpt.root) if ".tmp" in f]


# ---------------------------------------------------------------- schedules


def test_resume_training_flag_regimes(tree, tmp_path):
    """--resume_training turns the wrong-order, trap and cut-mix regimes on
    at once (model_wrapper.py:121-123, 272, 290-291, 331-332), and collapses
    the top-k schedule to v = 0.5 from the start."""
    trainer = _trainer(tree, tmp_path / "exp")
    trainer.epochs = 10
    assert trainer._epoch_flags(0) == (False, False, 0.0)
    wrong, trap, cm = trainer._epoch_flags(9)
    assert wrong and trap and cm == pytest.approx(0.45)
    assert trainer._epoch_flags(2) == (False, False, 0.1)
    assert trainer._epoch_flags(3)[:2] == (False, True)
    trainer.cfg = TrainingConfig(batch_size=4, resume_training=True)
    assert trainer._epoch_flags(0) == (True, True, 0.5)
    assert top_k_iterations(trainer.cfg, 100) == (0, 1)
    assert top_k_iterations(TrainingConfig(), 100) == (25, 75)


# --------------------------------------------------------- logger and utils


def test_logger_temp_metrics_equal_jax(tmp_path):
    ours, ref = Logger(str(tmp_path / "a")), JaxLogger(str(tmp_path / "b"))
    for log in (ours, ref):
        for v in (1.0, 2.0, 4.5):
            log.log_temp_metric("loss", v)
        log.log_hyperparameter("lr", 2e-4)
    assert ours.save_temp_metric("loss") == ref.save_temp_metric("loss") == {"loss": 2.5}
    assert ours.temp_metrics == ref.temp_metrics == {}
    for sub, name in (("metrics", "loss.npy"), ("hyperparameters", "hyperparameter.txt")):
        a, b = tmp_path / "a" / sub / name, tmp_path / "b" / sub / name
        assert a.read_bytes() == b.read_bytes(), name


def test_profiling_trace_and_step_timer(tmp_path):
    """A ``Trace`` window's Chrome JSON holds the profiler's events and the
    program's spans of the window (category ``program``, parent ids), on
    the profiler's clock: the span encloses the ``aten::mm`` it ran."""
    from multi_stylegan_torch.utils.profiling import span, trace

    with span("before"):  # no profiler yet: not recorded, not exported
        pass
    with trace(str(tmp_path / "trace")) as tr:
        with span("outer", step=3):
            with span("inner"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    doc = json.loads(open(tr.path).read())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    program = {e["name"]: e for e in events if e["cat"] == "program"}
    assert set(program) == {"outer", "inner"}
    assert program["outer"]["args"] == {"step": 3, "id": 0}
    assert program["inner"]["args"] == {"id": 1, "parent": 0}
    mm = next(e for e in events if e["name"] == "aten::mm")
    inner = program["inner"]
    assert inner["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= inner["ts"] + inner["dur"]
