"""The PyTorch port's ADA against the JAX package's (CPU).

The port's pipeline takes its draws as an argument; here they are rebuilt
from the JAX pipeline's own key schedule (ada.py:566-635), so both sides
warp with the same flips, angles, shifts, scales and gates.  Tolerance:
1e-4 abs on images in [0, 1] (the warp coordinates come from f32 sin/cos of
two libraries, one ulp apart), 1e-4 of the max abs on the image gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.train import ada as jax_ada
from multi_stylegan_torch.train import ada


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(rng, b, h, w, p):
    """The draws augmentation_pipeline(rng, ...) makes, as AdaDraws."""
    keys = jax.random.split(rng, 14)
    p = jnp.asarray(p, jnp.float32)
    p_rot = 1.0 - jnp.sqrt(jnp.clip(1.0 - p, 0.0, 1.0))
    max_h, max_w = max(1, int(0.125 * h)), max(1, int(0.125 * w))

    def gate(key, prob):
        return _t(np.asarray(jax.random.bernoulli(key, prob, (b,))))

    sig = jax_ada._LOGNORMAL_SIGMA
    return ada.AdaDraws(
        flip=gate(keys[0], p),
        rot90_index=_t(np.asarray(jax.random.randint(keys[1], (), 0, 4))).long(),
        rot90=gate(keys[2], p),
        shift=torch.tensor([int(jax.random.randint(keys[3], (), -max_h, max_h + 1)),
                            int(jax.random.randint(keys[4], (), -max_w, max_w + 1))]),
        translate=gate(keys[5], p),
        s_iso=_t(np.asarray(jnp.exp(jax.random.normal(keys[6], (b, 1)) * sig))),
        iso=gate(keys[7], p),
        angle=_t(np.asarray(jax.random.uniform(keys[8], (b,), minval=-180.0, maxval=180.0))),
        rot1=gate(keys[9], p_rot),
        s_aniso=_t(np.asarray(jnp.exp(jax.random.normal(keys[10], (b, 2)) * sig))),
        aniso=gate(keys[11], p),
        angle2=_t(np.asarray(jax.random.uniform(keys[12], (b,), minval=-180.0, maxval=180.0))),
        rot2=gate(keys[13], p_rot),
    )


@pytest.mark.parametrize("padding", ["reflect", "zeros"])
def test_apply_affine_matrix_matches_jax(rng, padding):
    """A given inverse map (rotation + anisotropic scale, sources past the
    border), values and the gradient w.r.t. the images; non-square."""
    b, h, w, c = 3, 12, 10, 4
    x = rng.uniform(size=(b, h, w, c)).astype(np.float32)
    ang = rng.uniform(-180, 180, size=(b,)).astype(np.float32)
    s = rng.uniform(0.7, 1.4, size=(b, 2)).astype(np.float32)
    inv = np.asarray(jax_ada._scale_mat(jnp.asarray(1.0 / s)) @ jax_ada._rot_mat(jnp.asarray(-ang)))
    ref = jax_ada.apply_affine_matrix(jnp.asarray(x), jnp.asarray(inv), padding)
    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    got = ada.apply_affine_matrix(xt, _t(inv), padding)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=0, atol=1e-4)
    cot = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ref_g = jax.grad(lambda a: jnp.sum(
        jax_ada.apply_affine_matrix(a, jnp.asarray(inv), padding) * cot))(jnp.asarray(x))
    (g,) = torch.autograd.grad((got * _t(cot.transpose(0, 3, 1, 2))).sum(), xt)
    np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(ref_g), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref_g)).max())


def test_rotation_and_scale_matrices_match_jax(rng):
    ang = rng.uniform(-180, 180, size=(5,)).astype(np.float32)
    s = rng.uniform(0.5, 2, size=(5, 2)).astype(np.float32)
    np.testing.assert_allclose(ada.rot_mat(_t(ang)).numpy(),
                               np.asarray(jax_ada._rot_mat(jnp.asarray(ang))), atol=1e-6)
    np.testing.assert_array_equal(ada.scale_mat(_t(s)).numpy(),
                                  np.asarray(jax_ada._scale_mat(jnp.asarray(s))))


@pytest.mark.parametrize("seed,p", [(0, 0.5), (1, 0.9), (2, 0.2)])
def test_pipeline_with_the_jax_draws_matches_jax(rng, seed, p):
    """Every stage (flip, 90-degree rotation, roll, the composed warp), gated
    per image with the JAX key schedule's draws; plus the image gradient."""
    b, h, w, c = 6, 16, 16, 6
    x = rng.uniform(size=(b, h, w, c)).astype(np.float32)
    key = jax.random.key(seed)
    ref = jax_ada.augmentation_pipeline(key, jnp.asarray(x), jnp.asarray(p))
    draws = jax_draws(key, b, h, w, p)
    assert draws.flip.any() and not draws.flip.all()
    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    got = ada.augmentation_pipeline(xt, draws)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=0, atol=1e-4)
    cot = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ref_g = jax.grad(lambda a: jnp.sum(
        jax_ada.augmentation_pipeline(key, a, jnp.asarray(p)) * cot))(jnp.asarray(x))
    (g,) = torch.autograd.grad((got * _t(cot.transpose(0, 3, 1, 2))).sum(), xt)
    np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(ref_g), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref_g)).max())


def test_p_zero_is_the_identity(rng):
    x = _t(rng.uniform(size=(4, 2, 3, 16, 16)).astype(np.float32))
    draws = ada.draw_ada(torch.Generator().manual_seed(0), 4, 16, 16, torch.tensor(0.0))
    assert not any(bool(getattr(draws, k).any()) for k in
                   ("flip", "rot90", "translate", "iso", "rot1", "aniso", "rot2"))
    torch.testing.assert_close(ada.augment_sequences(x, draws), x, rtol=0, atol=0)


def test_roll_matches_jnp_roll(rng):
    x = rng.normal(size=(2, 3, 7, 9)).astype(np.float32)
    for sh, sw in [(1, -2), (-3, 4), (0, 0)]:
        got = ada._roll(_t(x), torch.tensor([sh, sw]))
        np.testing.assert_array_equal(got.numpy(), np.roll(x, (sh, sw), axis=(2, 3)))


def test_controller_matches_jax(rng):
    s = rng.normal(size=(6, 1)).astype(np.float32)
    pp = rng.normal(size=(6, 1, 1, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(float(ada.calc_r(_t(s), _t(pp))),
                               float(jax_ada.calc_r(jnp.asarray(s), jnp.asarray(pp))), atol=1e-7)
    js, ps = jax_ada.AdaState.create(0.05), ada.AdaState.create(0.05)
    for r in [0.9, 0.8, float("nan"), 0.7, -0.5, 1.0, 0.95, 0.9, 0.2]:
        js = jax_ada.update_ada_state(js, jnp.asarray(r, jnp.float32), r_update=3)
        ps = ada.update_ada_state(ps, torch.tensor(r), r_update=3)
        for f in ("p", "r_sum", "r_count", "last_r"):
            np.testing.assert_allclose(float(getattr(ps, f)), float(getattr(js, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
    assert float(ps.p) != 0.05
