"""The port's trap-weighted D and G steps against the JAX sub-steps (CPU,
tiny config): with the map and the ``trap_weight`` flag on, the pixel
losses weight each pixel (JAX steps.py:139-146, 176-188, 289-298).  The
draws and tolerances are test_torch_port_train.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.train.noise import random_permutation as jax_random_permutation
from multi_stylegan_tpu.train.steps import StepFlags as JaxStepFlags
from multi_stylegan_tpu.train.steps import make_train_step
from multi_stylegan_torch.data.trap_weights import make_trap_weights_map
from test_torch_port_train import (
    B,
    ScriptedDraws,
    _assert_grads_match,
    _fake_draws,
    _jax_setup,
    _merge,
    _moments_by_name,
    _port_state,
    _real,
    _t,
)

TRAP = make_trap_weights_map((32, 32), inside_weight=4.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trap_steps():
    g, d, cfg, jstate, _ = _jax_setup()
    step_fn = make_train_step(g, d, cfg, top_k_start_iteration=0, top_k_final_iteration=4,
                              trap_weights_map=jnp.asarray(TRAP))
    state, ts = _port_state()
    ts.trap_weights_map = torch.from_numpy(TRAP)
    return jstate, step_fn, state, ts


def test_trap_weighted_d_step_matches_jax():
    """Wrong order on too: the fake pixel loss is the masked mean over the
    concat-equivalent batch, weighted per pixel."""
    jstate, step_fn, state, ts = _trap_steps()
    real, rng = _real(7), jax.random.key(21)
    on = jnp.asarray(True)
    js, _, _, _, jm = jax.jit(step_fn.d_step)(
        jstate, jnp.asarray(real), JaxStepFlags(wrong_order=on, trap_weight=on,
                                                do_cut_mix=jnp.asarray(False)), rng)
    k_fake, k_perm, _, _, _ = jax.random.split(rng, 5)
    draws = ScriptedDraws(**_merge(_fake_draws(k_fake, B), dict(perm=[torch.from_numpy(
        np.asarray(jax_random_permutation(k_perm, 3)).astype(np.int64))])))
    _, _, _, pm = ts.d_step(state, _t(real), True, draws, trap=True)
    assert draws.exhausted()
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-5, atol=1e-5, err_msg=k)
    _assert_grads_match(state.discriminator, state.d_opt,
                        _moments_by_name(js.d_opt_state, "d", None), 1e-4)
    # the map moved the pixel losses off their unweighted values
    plain = ts.d_losses(_port_state()[0], _t(real), True, ScriptedDraws(**_merge(
        _fake_draws(k_fake, B), dict(perm=[torch.zeros(3, dtype=torch.long)]))))[0]
    assert abs(float(plain["loss_discriminator_real_pixel_wise"].detach())
               - float(pm["loss_discriminator_real_pixel_wise"])) > 1e-4


def test_trap_weighted_g_step_matches_jax():
    jstate, step_fn, state, ts = _trap_steps()
    jstate = jstate.replace(step=jstate.step + 2)  # inside the top-k ramp: a real mask
    rng = jax.random.key(22)
    flags = JaxStepFlags(wrong_order=jnp.asarray(False), trap_weight=jnp.asarray(True),
                         do_cut_mix=jnp.asarray(False))
    js, jm = jax.jit(step_fn.g_step, static_argnums=1)(jstate, B, flags, rng)
    k_fake, _ = jax.random.split(rng)
    draws = ScriptedDraws(**_fake_draws(k_fake, B))
    state.step = 2
    pm = ts.g_step(state, B, draws, trap=True)
    assert draws.exhausted()
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-5, atol=1e-5, err_msg=k)
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    _assert_grads_match(state.generator, state.g_opt,
                        _moments_by_name(js.g_opt_state, "g", noises), 1e-4)
