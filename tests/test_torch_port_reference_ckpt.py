"""Reference-format ``.pt`` import and export in the port (io/reference.py,
cli/convert.py, cli/export.py, ``cli.train --load_checkpoint x.pt``)
against the JAX package's io/torch_convert.py (CPU, tiny configs).

The JAX state is test_torch_port_train.py's (every parameter perturbed)
after two Adam updates of each optimizer from random gradients, so every
moment and both counts are nonzero.  Weights and moments move by layout
only: bitwise.  One Adam update after the import against optax's on the
same gradients: 1e-4 of the peak (f32 both sides).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.io.torch_convert import (
    convert_reference_checkpoint as jax_convert,
    export_reference_checkpoint as jax_export,
)
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_g
from multi_stylegan_tpu.train.state import (
    extract_adam_moments,
    make_discriminator_optimizer as jax_d_opt,
    make_generator_optimizer as jax_g_opt,
)
from multi_stylegan_torch.cli import convert as convert_cli
from multi_stylegan_torch.cli import export as export_cli
from multi_stylegan_torch.cli import train as train_cli
from multi_stylegan_torch.io.checkpoint import CheckpointManager, read_checkpoint
from multi_stylegan_torch.io.from_jax import (
    discriminator_state_from_jax,
    generator_state_from_jax,
    train_state_from_jax,
)
from multi_stylegan_torch.io.reference import (
    export_reference_checkpoint,
    generator_adam_order,
    import_reference_checkpoint,
)
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.train.state import create_train_state
from test_torch_port_train import CFG_KW, _jax_setup, _np_state


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny-config work: the suite
    runs several worker processes on a few cores, and more threads only
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _trained():
    """_jax_setup's state after two Adam updates of G and D."""
    _, _, cfg, state, step_fn = _jax_setup()
    rng = np.random.default_rng(31)
    for opt, params_key, opt_key in ((jax_g_opt(cfg), "g_params", "g_opt_state"),
                                     (jax_d_opt(cfg), "d_params", "d_opt_state")):
        params, opt_state = getattr(state, params_key), getattr(state, opt_key)
        update = jax.jit(opt.update)
        for _ in range(2):
            grads = jax.tree.map(lambda a: jnp.asarray(
                rng.normal(size=a.shape).astype(np.float32)), params)
            updates, opt_state = update(grads, opt_state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
        state = state.replace(**{params_key: params, opt_key: opt_state})
    return state.replace(mean_path_length=jnp.asarray(0.0, jnp.float32)), step_fn


def _jax_pt(jstate, path):
    """The JAX exporter's .pt of ``jstate``."""
    torch.save(jax_export(jstate.g_params, jstate.g_noises, jstate.g_ema_params, jstate.d_params,
                          jax_tiny_g(), jax_tiny_d(),
                          g_adam=extract_adam_moments(jstate.g_opt_state),
                          d_adam=extract_adam_moments(jstate.d_opt_state)), path)
    return str(path)


def _fresh_state():
    return create_train_state(Generator(tiny_generator_config()),
                              Discriminator(tiny_discriminator_config()), TrainingConfig(**CFG_KW))


def _assert_states_equal(a, b, with_counts=True):
    for name in ("generator", "g_ema", "discriminator"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys(), name
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=f"{name}.{k}")
    for name in ("g_opt", "d_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        for x, y in zip(oa.exp_avg + oa.exp_avg_sq, ob.exp_avg + ob.exp_avg_sq):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
        if with_counts:
            assert int(oa.count) == int(ob.count) == 2, name


@pytest.fixture(scope="module")
def jax_pt(tmp_path_factory):
    jstate, _ = _trained()
    return _jax_pt(jstate, tmp_path_factory.mktemp("ref") / "jax.pt")


def test_jax_export_imports_bitwise(jax_pt):
    jstate, _ = _trained()
    want = train_state_from_jax(_np_state(jstate), tiny_generator_config(),
                                tiny_discriminator_config(), TrainingConfig(**CFG_KW))
    state = _fresh_state()
    found = import_reference_checkpoint(state, read_checkpoint(jax_pt))
    assert found == ["G Adam", "D Adam"]
    _assert_states_equal(state, want)
    assert all(float(m.abs().max()) > 0 for m in state.g_opt.exp_avg_sq + state.d_opt.exp_avg_sq)


def test_one_step_after_the_import_matches_jax(jax_pt):
    """One more Adam update of G and of D from the imported state (moments
    and count 2 in place) against optax's from the JAX state, on the same
    gradients: the new moments and the parameter updates."""
    jstate, _ = _trained()
    _, _, cfg, _, _ = _jax_setup()
    rng = np.random.default_rng(32)
    state = _fresh_state()
    import_reference_checkpoint(state, read_checkpoint(jax_pt))
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    for opt, params, opt_state, port_module, port_opt, to_sd in (
            (jax_g_opt(cfg), jstate.g_params, jstate.g_opt_state, state.generator, state.g_opt,
             lambda t: generator_state_from_jax(t, noises, tiny_generator_config())),
            (jax_d_opt(cfg), jstate.d_params, jstate.d_opt_state, state.discriminator,
             state.d_opt, lambda t: discriminator_state_from_jax(t, tiny_discriminator_config()))):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, new_state = jax.jit(opt.update)(grads, opt_state, params)
        new_params = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
        names = {id(p): n for n, p in port_module.named_parameters()}
        by_name = to_sd(grads)
        before = [p.detach().clone() for p in port_opt.params]
        port_opt.step([by_name[names[id(p)]].reshape(p.shape) for p in port_opt.params])
        moments = extract_adam_moments(new_state)
        assert int(port_opt.count) == int(moments["count"]) == 3
        for got, ref in ((port_opt.exp_avg, to_sd(jax.tree.map(np.asarray, moments["mu"]))),
                         (port_opt.exp_avg_sq, to_sd(jax.tree.map(np.asarray, moments["nu"])))):
            ref = [ref[names[id(p)]].reshape(p.shape) for p in port_opt.params]
            peak = max(float(r.abs().max()) for r in ref)
            for a, b in zip(got, ref):
                assert float((a - b).abs().max()) <= 1e-4 * peak
        # the parameter updates, to 1e-4 of their peak plus the rounding of p + update
        want = to_sd(new_params)
        want = [want[names[id(p)]].reshape(p.shape) for p in port_opt.params]
        peak = max(float((w - b).abs().max()) for w, b in zip(want, before))
        assert peak > 0
        for p, w, b in zip(port_opt.params, want, before):
            ulp = 2.0 ** -23 * float(b.abs().max())
            assert float((p.detach() - w).abs().max()) <= 1e-4 * peak + 2 * ulp


def test_port_export_is_the_jax_export_and_converts_back(tmp_path):
    """The port's export of a state equals the JAX exporter's of the same
    state (keys, tensors, param groups), and JAX's converter reads it back
    to the JAX state, bitwise."""
    jstate, _ = _trained()
    state = train_state_from_jax(_np_state(jstate), tiny_generator_config(),
                                 tiny_discriminator_config(), TrainingConfig(**CFG_KW))
    ours = export_reference_checkpoint(state, TrainingConfig(**CFG_KW))
    ref = torch.load(_jax_pt(jstate, tmp_path / "jax.pt"), weights_only=False)
    assert ours.keys() == ref.keys()
    for key in ("generator_ema", "generator", "discriminator"):
        assert ours[key].keys() == ref[key].keys(), key
        for k in ref[key]:
            torch.testing.assert_close(ours[key][k], ref[key][k], rtol=0, atol=0, msg=k)
    for key in ("generator_optimizer", "discriminator_optimizer"):
        assert ours[key]["param_groups"] == ref[key]["param_groups"], key
        assert ours[key]["state"].keys() == ref[key]["state"].keys()
        for i, st in ref[key]["state"].items():
            assert ours[key]["state"][i]["step"] == st["step"] == 2
            for m in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(ours[key]["state"][i][m], st[m], rtol=0, atol=0)
    assert len(ours["generator_optimizer"]["param_groups"]) == 11
    assert ours["path_length_regularization"] == {}

    torch.save(ours, tmp_path / "port.pt")
    back = jax_convert(str(tmp_path / "port.pt"), jax_tiny_g(), jax_tiny_d())
    pairs = [(back["generator"]["params"], jstate.g_params),
             (back["generator"]["noises"], jstate.g_noises),
             (back["generator_ema"]["params"], jstate.g_ema_params),
             (back["discriminator"]["params"], jstate.d_params)]
    for kind, opt_state in (("generator_adam", jstate.g_opt_state),
                            ("discriminator_adam", jstate.d_opt_state)):
        want = extract_adam_moments(opt_state)
        assert back[kind]["count"] == int(want["count"]) == 2
        pairs += [(back[kind]["mu"], want["mu"]), (back[kind]["nu"], want["nu"])]
    for got, want in pairs:
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                     got, want)


def test_generator_adam_order_is_the_jax_order():
    from multi_stylegan_tpu.io.torch_convert import generator_adam_order as jax_order

    assert generator_adam_order(tiny_generator_config()) == [k for k, _, _ in
                                                             jax_order(jax_tiny_g())]


def test_convert_and_export_clis_round_trip(jax_pt, tmp_path, capsys):
    """.pt -> cli.convert -> checkpoint_<step>.pt (the imported state, at
    --step) -> cli.export -> .pt equal to the first, tensor for tensor."""
    path = convert_cli.main([jax_pt, str(tmp_path / "models"), "--tiny", "--step", "7"])
    assert os.path.basename(path) == "checkpoint_7.pt"
    assert "G Adam, D Adam" in capsys.readouterr().out
    saved = CheckpointManager(str(tmp_path / "models")).load()["train_state"]
    assert saved["step"] == 7
    state = _fresh_state()
    import_reference_checkpoint(state, read_checkpoint(jax_pt))
    for name in ("generator", "g_ema", "discriminator"):
        want = getattr(state, name).state_dict()
        for k, v in saved[name].items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    out = export_cli.main([str(tmp_path / "models"), str(tmp_path / "again.pt"), "--tiny"])
    a, b = (torch.load(p, weights_only=True) for p in (jax_pt, out))
    assert a.keys() == b.keys()
    flat = {}

    def visit(prefix, x, y):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), prefix
            for k in x:
                visit(f"{prefix}.{k}", x[k], y[k])
        elif isinstance(x, torch.Tensor):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=prefix)
            flat[prefix] = x
        else:
            assert x == y, prefix

    visit("", a, b)
    assert len(flat) > 100


def test_cli_train_from_a_reference_pt(jax_pt, tmp_path, capsys):
    """``--load_checkpoint x.pt`` installs G, G-EMA, D and both Adam states
    (their counts go on from 2) and trains."""
    run = train_cli.main(["--tiny", "--synthetic", "--device", "cpu", "--epochs", "1",
                          "--batch_size", "16", "--no_validation_metrics",
                          "--load_checkpoint", jax_pt, "--experiment_path", str(tmp_path / "e")])
    out = capsys.readouterr().out
    assert "Loaded reference .pt checkpoint" in out and "G Adam, D Adam" in out
    state = run["state"]
    assert run["steps"] == 4 and run["finite"]
    assert int(state.g_opt.count) == int(state.d_opt.count) == 2 + 4
