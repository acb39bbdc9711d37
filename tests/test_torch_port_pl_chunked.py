"""The port's split and chunked path-length update and its out-of-memory
ladder (train/steps.py, train/robust.py) on the CPU, tiny configs.

Chunked against unchunked in the port: the same draws, sums in another
order, 1e-5 of the gradient's peak.  Against the JAX package's
``path_length_grads_chunked`` (a two-stage, 16 x 16 tiny generator, for a
quicker compile): every draw rebuilt from its key schedule, 1e-3 of the
peak (grad of grad, f32 both sides; tests/test_train_step.py
holds JAX's own chunked form to its unchunked one at this size).  The
ladder's trigger is a ``torch.cuda.OutOfMemoryError``, injected here.
"""

import math
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.models import Discriminator as JaxDiscriminator
from multi_stylegan_tpu.models import Generator as JaxGenerator
from multi_stylegan_tpu.models.config import TrainingConfig as JaxTrainingConfig
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_g
from multi_stylegan_tpu.train.robust import pl_chunk_tiers as jax_pl_chunk_tiers
from multi_stylegan_tpu.train.steps import make_train_step
from multi_stylegan_torch.data.pipeline import make_loader
from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.io.from_jax import generator_state_from_jax
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.ema import ema_update
from multi_stylegan_torch.train.loop import Trainer
from multi_stylegan_torch.train.robust import RobustPathLength, pl_chunk_tiers
from multi_stylegan_torch.train.state import create_train_state
from multi_stylegan_torch.train.steps import PathLengthDraws, TrainStep
from test_torch_port_train import _t, _wplus_draws


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny-config work: the suite
    runs several worker processes on a few cores, and more threads only
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

B = 8  # path-length batch 4: chunkings 1, 2 and 4
SMALL = dict(channels=(32, 32, 32))  # a 16 x 16, two-stage tiny generator: less to compute


def _state(seed=0, **g_kw):
    g, d = Generator(tiny_generator_config(**g_kw)), Discriminator(tiny_discriminator_config())
    g.reset_parameters(torch.Generator().manual_seed(seed))
    d.reset_parameters(torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():  # zero-initialised biases and noise weights carry signal too
        for p in g.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 2)))
    cfg = TrainingConfig(batch_size=B)
    state = create_train_state(g, d, cfg)
    state.mean_path_length = torch.tensor(0.03)
    return state, TrainStep(cfg)


def _named(state, grads):
    names = {id(p): n for n, p in state.generator.named_parameters()}
    return {names[id(p)]: g for p, g in zip(state.g_opt.params, grads)}


def test_chunked_equals_unchunked():
    state, ts = _state(**SMALL)
    pld = ts.draw_path_length(state.generator, B, TorchDraws(torch.Generator().manual_seed(5)))
    assert pld.probe.shape[0] == 4
    ref_grads, ref_pen, ref_pl, ref_mean = ts.path_length_grads(state, pld, 1)
    ref = _named(state, ref_grads)
    peak = max(float(g.abs().max()) for g in ref.values() if g is not None)
    assert peak > 0 and float(ref_pen) > 0
    for n_chunks in (2, 4):
        grads, pen, pl, new_mean = ts.path_length_grads(state, pld, n_chunks)
        np.testing.assert_allclose([float(pen), float(pl), float(new_mean)],
                                   [float(ref_pen), float(ref_pl), float(ref_mean)], rtol=1e-5)
        for name, g in _named(state, grads).items():
            if ref[name] is None:  # the image is linear in it: no second-order gradient
                assert g is None, name
                continue
            assert float((g - ref[name]).abs().max()) <= 1e-5 * peak, (n_chunks, name)
    with pytest.raises(ValueError, match="divisible"):
        ts.path_length_grads(state, pld, 3)


def test_split_update_equals_the_whole_update():
    """path_length_update (draws, path_length_grads, path_length_apply) is
    the JAX-named path_length_step followed by the EMA: the same parameters,
    moments, running mean and EMA, bitwise."""
    results = []
    for split in (False, True):
        state, ts = _state(**SMALL)
        draws = TorchDraws(torch.Generator().manual_seed(6))
        if split:
            pen, pl = ts.path_length_update(state, draws)
        else:
            pen, pl = ts.path_length_step(state, B, draws)
            ema_update(state.g_ema, state.generator, ts.cfg.ema_decay)
        results.append([float(pen), float(pl), state.mean_path_length.clone()]
                       + [p.detach().clone() for p in state.generator.parameters()]
                       + [p.clone() for p in state.g_ema.parameters()] + list(state.g_opt.exp_avg_sq))
    for a, b in zip(*results):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_chunked_grads_match_jax():
    """The port's 2-chunk grads against ``path_length_grads_chunked(2)`` at
    batch 4 (path-length batch 2), every draw rebuilt from the JAX keys."""
    g = JaxGenerator(jax_tiny_g(**SMALL))
    keys = dict(zip(("params", "noise", "mixing"), jax.random.split(jax.random.key(0), 3)))
    v = jax.jit(g.init)(keys, jnp.zeros((1, 32)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32), v["params"])
    noises = jax.tree.map(np.asarray, v["noises"])
    step_fn = make_train_step(g, JaxDiscriminator(jax_tiny_d()), JaxTrainingConfig(batch_size=4))
    fields = dict(g_params=params, g_noises=noises, rng=jax.random.key(5),
                  step=jnp.asarray(3, jnp.int32), mean_path_length=jnp.asarray(0.05, jnp.float32))
    grads, jpen, jpl, jmean = jax.jit(
        lambda f: step_fn.path_length_grads_chunked(2)(types.SimpleNamespace(**f)))(fields)
    base = jax.random.fold_in(jax.random.fold_in(fields["rng"], 3), 17)
    k_w, k_n, k_pl = jax.random.split(base, 3)
    bs = step_fn.path_length_batch
    gcfg = tiny_generator_config(**SMALL)
    latents, inject = _wplus_draws(k_w, bs, n_latents=gcfg.n_latents)
    noise = [_t(np.asarray(n).transpose(0, 3, 1, 2)) for n in g.random_noise(bs, k_n)]
    pld = PathLengthDraws(latents, inject, noise, _t(jax.random.normal(k_pl, (bs, 2, 3, 16, 16))))
    port = Generator(gcfg)
    port.load_state_dict(generator_state_from_jax(params, noises, gcfg))
    state = create_train_state(port, Discriminator(tiny_discriminator_config()),
                               TrainingConfig(batch_size=4))
    state.mean_path_length = torch.tensor(0.05)
    p_grads, pen, pl, new_mean = TrainStep(TrainingConfig(batch_size=4)).path_length_grads(
        state, pld, 2)
    np.testing.assert_allclose([float(pen), float(pl), float(new_mean)],
                               [float(jpen), float(jpl), float(jmean)], rtol=1e-4)
    ref = generator_state_from_jax(jax.tree.map(np.asarray, grads), noises, gcfg)
    got = _named(state, p_grads)
    peak = max(float(ref[n].abs().max()) for n in got)
    assert peak > 0
    for name, gr in got.items():
        gr = torch.zeros_like(ref[name]) if gr is None else gr
        assert float((gr - ref[name].reshape(gr.shape)).abs().max()) <= 1e-3 * peak, name


@pytest.mark.parametrize("pl_batch", [1, 2, 3, 4, 6, 8, 12, 16, 24])
def test_chunk_tiers_match_jax(pl_batch):
    assert pl_chunk_tiers(pl_batch) == tuple(jax_pl_chunk_tiers(pl_batch))


def _failing_below(ts, n_ok, calls):
    """Make ``ts.path_length_grads`` run out of memory below ``n_ok`` chunks
    (``n_ok`` None: always), recording the chunk counts tried."""
    inner = ts.path_length_grads

    def grads(state, pld, n_chunks=1):
        calls.append(n_chunks)
        if n_ok is None or n_chunks < n_ok:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB")
        return inner(state, pld, n_chunks)
    ts.path_length_grads = grads


def test_ladder_demotes_on_out_of_memory_and_keeps_the_tier():
    """Out of memory unchunked and in 2 chunks: the update runs in 4, the
    same update as the unchunked one on the same draws, and later updates
    start at 4 chunks."""
    ref_state, ref_ts = _state(**SMALL)
    ref_ts.path_length_update(ref_state, TorchDraws(torch.Generator().manual_seed(7)))
    state, ts = _state(**SMALL)
    calls, printed = [], []
    _failing_below(ts, 4, calls)
    robust = RobustPathLength(ts, report=printed.append)
    assert robust.tiers == (1, 2, 4)
    draws = TorchDraws(torch.Generator().manual_seed(7))
    pen, pl, metrics = robust(state, draws)
    assert calls == [1, 2, 4] and robust.chunks == 4 and len(printed) == 2
    assert float(metrics["path_length_chunks"]) == 4 and float(metrics["path_length_skipped"]) == 0
    assert math.isfinite(float(pen)) and float(pl) > 0
    # with b1 = 0 the first moment is the (clipped) gradient
    peak = max(float(m.abs().max()) for m in ref_state.g_opt.exp_avg)
    for a, b in zip(state.g_opt.exp_avg, ref_state.g_opt.exp_avg):
        assert float((a - b).abs().max()) <= 1e-5 * peak
    calls.clear()
    ts.path_length_grads = lambda state, pld, n_chunks=1: calls.append(n_chunks) or (
        [None] * len(state.g_opt.params), pen, pl, state.mean_path_length)
    robust(state, draws)
    assert calls == [4]


def test_ladder_skips_the_update_when_every_tier_fails():
    """Every chunking out of memory: a warning, the G parameters, the
    running mean and the EMA untouched (the JAX Trainer's skipped step
    returns its state unchanged), the skip in the metrics; later updates are
    skipped without another try (the JAX Trainer's policy)."""
    state, ts = _state(**SMALL)
    calls = []
    _failing_below(ts, None, calls)
    robust = RobustPathLength(ts, report=lambda m: None)
    before = [p.detach().clone() for p in state.generator.parameters()]
    ema_before = [p.clone() for p in state.g_ema.parameters()]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pen, pl, metrics = robust(state, TorchDraws(torch.Generator().manual_seed(8)))
    assert calls == [1, 2, 4] and robust.chunks == 0
    assert any("DISABLED" in str(w.message) for w in caught)
    assert float(metrics["path_length_skipped"]) == 1 and float(metrics["path_length_chunks"]) == 0
    assert float(pen) == 0 and float(state.mean_path_length) == pytest.approx(0.03)
    assert all(torch.equal(a, b) for a, b in zip(before, state.generator.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(ema_before, state.g_ema.parameters()))
    calls.clear()
    robust(state, TorchDraws(torch.Generator().manual_seed(9)))
    assert calls == []


def test_trainer_takes_the_path_length_update_through_the_ladder(tmp_path, monkeypatch, capsys):
    """The trainer's path-length update (every 2nd step here) goes through
    the ladder: out of memory unchunked, it runs in 2 chunks and says so in
    its metrics and output."""
    inner = TrainStep.path_length_grads

    def grads(self, state, pld, n_chunks=1):
        if n_chunks == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return inner(self, state, pld, n_chunks)
    monkeypatch.setattr(TrainStep, "path_length_grads", grads)
    state, _ = _state()
    cfg = TrainingConfig(batch_size=4, lazy_generator_regularization=2)
    loader = make_loader(SyntheticTLFMDataset(n_samples=8, resolution=(32, 32)), 4)
    trainer = Trainer(state.generator, state.discriminator, cfg, loader,
                      TorchDraws(torch.Generator().manual_seed(0)), epochs=1,
                      data_logger=Logger(experiment_path=str(tmp_path / "exp")))
    hist = trainer.train()
    assert len(hist) == 2 and hist[-1]["path_length"] > 0
    assert [m["path_length_chunks"] for m in hist] == [0, 2]
    assert [m["path_length_skipped"] for m in hist] == [0, 0]
    assert "retrying in 2 chunks" in capsys.readouterr().out
