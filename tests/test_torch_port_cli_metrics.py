"""The training CLI's validation metrics are built at the metrics' own
default batch, as the JAX CLI builds ``(FID(), FVD(), IS())``
(multi_stylegan_tpu/cli/train.py), not at ``--batch_size``: FID and IS draw
one timestep per batch and domain, so the batch decides which fakes share
one.  The JAX default is read from ``_MetricBase.__init__``'s signature; no
JAX model runs.  The nets are the stand-ins of ``torch_eval_stubs.py`` at
random weights (the CLI passes no weights here)."""

import inspect

import pytest
import torch

import torch_eval_stubs
from multi_stylegan_tpu.eval.metrics import _MetricBase as JaxMetricBase
from multi_stylegan_torch.cli import train as train_cli
from multi_stylegan_torch.eval import metrics


def _default_batch(cls) -> int:
    return inspect.signature(cls.__init__).parameters["batch_size"].default


@pytest.fixture
def random_weights(monkeypatch):
    """The stand-in nets, taken at random weights whatever the caller asks."""
    torch_eval_stubs.install(monkeypatch.setattr)
    load = metrics._load_net
    monkeypatch.setattr(metrics, "_load_net",
                        lambda path, env, from_sd, net, allow, what: load(path, env, from_sd, net,
                                                                          True, what))


def test_port_metric_default_batch_is_the_jax_one():
    assert _default_batch(metrics._MetricBase) == _default_batch(JaxMetricBase) == 24


@pytest.mark.parametrize("batch_size", ["8", "24", "32"])
def test_cli_builds_its_metrics_at_the_jax_default_batch(batch_size, random_weights):
    args = train_cli.build_parser().parse_args(
        ["--tiny", "--synthetic", "--device", "cpu", "--batch_size", batch_size])
    built = train_cli.validation_metrics(args, 32, torch.device("cpu"), data_samples=48)
    assert [type(m).__name__ for m in built] == ["FID", "FVD", "IS"]
    for m in built:
        assert m.batch_size == _default_batch(JaxMetricBase)
        assert (m.latent_dimensions, m.data_samples) == (32, 48)


def test_cli_builds_no_metrics_without_weights(monkeypatch):
    for env in ("MSG_TPU_INCEPTION_PT", "MSG_TPU_I3D_PT"):
        monkeypatch.delenv(env, raising=False)
    args = train_cli.build_parser().parse_args(
        ["--tiny", "--synthetic", "--device", "cpu", "--batch_size", "8"])
    assert train_cli.validation_metrics(args, 32, torch.device("cpu")) == ()
