"""The PyTorch port's discriminator, NonLocal block, minibatch std-dev and
cut-mix helpers against the JAX package's (CPU, tiny configs).

Weights cross through ``discriminator_state_from_jax``; inputs come from
numpy.  Tolerances: forward 1e-4 abs, gradients 1e-4 and grad-of-grad 1e-3
of the gradient's max abs (f32 on both sides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.io.torch_convert import export_discriminator
from multi_stylegan_tpu.models import Discriminator as JaxDiscriminator
from multi_stylegan_tpu.models.config import DiscriminatorConfig as JaxDiscriminatorConfig
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.models.discriminator import (
    generate_cut_mix_augmentation_data as jax_cut_aug,
    generate_cut_mix_transformation_data as jax_cut_trans,
)
from multi_stylegan_tpu.nn.attention import NonLocalBlock as JaxNonLocal
from multi_stylegan_tpu.nn.attention import _max_pool_2x as jax_max_pool
from multi_stylegan_tpu.nn.normalization import minibatch_std_dev as jax_mbstd
from multi_stylegan_torch.io.from_jax import discriminator_state_from_jax
from multi_stylegan_torch.models.config import DiscriminatorConfig, tiny_discriminator_config
from multi_stylegan_torch.models.discriminator import (
    Discriminator,
    binary_cut_mix_map,
    generate_cut_mix_augmentation_data,
    generate_cut_mix_transformation_data,
)
from multi_stylegan_torch.nn.attention import NonLocalBlock, max_pool_2x
from multi_stylegan_torch.nn.normalization import minibatch_std_dev


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


@functools.lru_cache(maxsize=None)
def _pair(seed=0):
    """JAX tiny discriminator params, every leaf perturbed (biases and the
    NonLocal gammas nonzero), and the port loaded with them."""
    cfg = jax_tiny_d()
    v = JaxDiscriminator(cfg).init(jax.random.key(seed), jnp.zeros((2, 2, 3, 32, 32)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32), v["params"])
    port = Discriminator(tiny_discriminator_config())
    port.load_state_dict(discriminator_state_from_jax(params, tiny_discriminator_config()),
                         strict=True)
    return JaxDiscriminator(cfg), params, port


def test_discriminator_forward_matches_jax(rng):
    model, params, port = _pair()
    assert all(abs(float(m.gamma.detach())) > 0 for m in port.modules() if isinstance(m, NonLocalBlock))
    x = rng.uniform(size=(3, 2, 3, 32, 32)).astype(np.float32)
    ref_s, ref_p = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        s, p = port(_t(x))
    assert s.shape == (3, 1) and p.shape == (3, 1, 1, 32, 32) and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=0, atol=1e-4)


def test_discriminator_input_gradient_matches_jax(rng):
    """First order through every D op (K1 and K3 Functions included)."""
    model, params, port = _pair()
    x = rng.uniform(size=(2, 2, 3, 32, 32)).astype(np.float32)

    def f(xx):
        s, p = model.apply({"params": params}, xx)
        return jnp.sum(s) + jnp.sum(p * 0.5)

    ref = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    s, p = port(xt)
    (got,) = torch.autograd.grad(s.sum() + (p * 0.5).sum(), xt)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_state_from_jax_equals_the_jax_exporter():
    _, params, port = _pair()
    ours = discriminator_state_from_jax(params, tiny_discriminator_config())
    ref = export_discriminator(params, jax_tiny_d())
    assert set(ours) == set(ref) == set(port.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v).reshape(ours[k].shape),
                                      err_msg=k)


def test_full_config_state_dict_layout():
    """At the flagship config: keys and shapes are export_discriminator's and
    the parameter count is the JAX model's (shapes only, no forward)."""
    jcfg = JaxDiscriminatorConfig(no_rfp=True)
    shapes = jax.eval_shape(JaxDiscriminator(jcfg).init, jax.random.key(0),
                            jnp.zeros((2, 2, 3, 256, 256)))["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = export_discriminator(zeros, jcfg)
    port = Discriminator(DiscriminatorConfig(no_rfp=True), device="meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == {k: tuple(np.shape(v)) for k, v in ref.items()}
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) == n_jax


def test_config_fields_match_jax():
    import dataclasses

    from multi_stylegan_tpu.models.config import TrainingConfig as JaxTrainingConfig
    from multi_stylegan_torch.models.config import TrainingConfig

    for port_cfg, jax_cfg in ((DiscriminatorConfig(), JaxDiscriminatorConfig()),
                              (tiny_discriminator_config(), jax_tiny_d()),
                              (TrainingConfig(), JaxTrainingConfig())):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert DiscriminatorConfig(no_rfp=True).input_channels == 6


def test_max_pool_matches_jax_with_ties(rng):
    base = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    x = np.repeat(np.repeat(base, 2, axis=2), 2, axis=3)  # every window a 4-way tie
    x[0, 0, 0, 1] = x[0, 0, 0, 0] + 1.0  # one window with a unique max
    ref = jax_max_pool(jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(max_pool_2x(_t(x)).numpy(),
                                  np.asarray(ref).transpose(0, 3, 1, 2))
    # the gradient goes to the first maximum of each window only
    xt = _t(x).requires_grad_(True)
    (gx,) = torch.autograd.grad(max_pool_2x(xt).sum(), xt)
    ref_g = jax.grad(lambda a: jnp.sum(jax_max_pool(a)))(jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(ref_g).transpose(0, 3, 1, 2))
    assert float(gx[0, 0, 0, 1]) == 1.0 and float(gx[0, 0, 0, 0]) == 0.0
    assert float(gx[1, 0, 0, 0]) == 1.0 and float(gx[1, 0, 0, 1]) == 0.0


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 24)])
def test_nonlocal_block_value_grad_and_grad_of_grad_match_jax(rng, cin, cout):
    """Nonzero gamma, an input whose 2x2 windows tie, and R1's structure
    (the gradient of a squared input-gradient norm w.r.t. the parameters)."""
    base = rng.normal(size=(2, 4, 4, cin)).astype(np.float32)
    x = np.repeat(np.repeat(base, 2, axis=1), 2, axis=2)
    jblock = JaxNonLocal(cout)
    params = jblock.init(jax.random.key(1), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=np.shape(a)).astype(np.float32),
                          params)
    port = NonLocalBlock(cin, cout)
    sd = {"gamma": _t(np.asarray(params["gamma"]).reshape(()))}
    for name in ("theta", "phi", "g", "o") + (("residual",) if cin != cout else ()):
        key = "residual_mapping" if name == "residual" else name
        sd[f"{key}.weight"] = _t(np.asarray(params[name]["weight"]).transpose(3, 2, 0, 1))
    port.load_state_dict(sd, strict=True)
    assert float(port.gamma) != 0

    def r1_like(p, xx):
        gx = jax.grad(lambda a: jnp.sum(jnp.square(jblock.apply({"params": p}, a))))(xx)
        return jnp.sum(jnp.square(gx))

    ref_y = jblock.apply({"params": params}, jnp.asarray(x))
    ref_gp = jax.grad(r1_like)(params, jnp.asarray(x))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y = port(xt)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref_y),
                               rtol=0, atol=1e-4)
    (gx,) = torch.autograd.grad(y.square().sum(), xt, create_graph=True)
    names, ps = zip(*port.named_parameters())
    grads = torch.autograd.grad(gx.square().sum(), ps)
    refs = {"gamma": np.asarray(ref_gp["gamma"])}
    for name in ("theta", "phi", "g", "o") + (("residual",) if cin != cout else ()):
        key = "residual_mapping" if name == "residual" else name
        refs[f"{key}.weight"] = np.asarray(ref_gp[name]["weight"]).transpose(3, 2, 0, 1)
    peak = max(np.abs(v).max() for v in refs.values())
    for n, g in zip(names, grads):
        err = np.abs(g.numpy() - refs[n].reshape(g.shape)).max()
        assert err <= 1e-3 * peak, (n, err, peak)


def test_minibatch_std_dev_matches_jax(rng):
    x = rng.normal(size=(3, 5, 4, 6)).astype(np.float32)
    x[:, 0, 0, 0] = 1.0  # zero batch variance: the eps clamp
    ref = jax_mbstd(jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = minibatch_std_dev(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-6, atol=1e-6)
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(minibatch_std_dev(xt)[:, -1].sum(), xt)
    ref_g = jax.grad(lambda a: jnp.sum(jax_mbstd(a)[..., -1]))(jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("cut", [(5, 9, True, False), (20, 3, False, True), (3, 28, False, False)])
def test_cut_mix_maps_and_mixes_match_jax(rng, cut, monkeypatch):
    """Given the cut coordinates the JAX helpers draw, the maps and mixes
    are the same.  The JAX draws are pinned by monkeypatching jax.random."""
    import multi_stylegan_tpu.models.discriminator as jdisc

    ch, cw, corner, invert = cut
    draws = iter([ch, cw])
    uniforms = iter([0.9 if corner else 0.1, 0.9 if invert else 0.1])
    monkeypatch.setattr(jdisc.jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(next(draws)))
    monkeypatch.setattr(jdisc.jax.random, "uniform",
                        lambda key, shape: jnp.asarray(next(uniforms)))
    real = rng.uniform(size=(2, 2, 3, 32, 32)).astype(np.float32)
    fake = rng.uniform(size=(3, 2, 3, 32, 32)).astype(np.float32)
    mixed, target = generate_cut_mix_augmentation_data(cut, _t(real), _t(fake))
    ref_mixed, ref_target = jax_cut_aug(jax.random.key(0), jnp.asarray(real), jnp.asarray(fake))
    np.testing.assert_array_equal(target.numpy(), np.asarray(ref_target))
    np.testing.assert_array_equal(mixed.numpy(), np.asarray(ref_mixed))
    assert binary_cut_mix_map(cut, 32, 32).shape == (1, 1, 1, 32, 32)

    draws = iter([ch, cw])
    uniforms = iter([0.9 if corner else 0.1, 0.9 if invert else 0.1])
    pr = rng.normal(size=(2, 1, 1, 32, 32)).astype(np.float32)
    pf = rng.normal(size=(3, 1, 1, 32, 32)).astype(np.float32)
    m2, t2 = generate_cut_mix_transformation_data(cut, _t(real), _t(fake), _t(pr), _t(pf))
    rm2, rt2 = jax_cut_trans(jax.random.key(0), *(jnp.asarray(a) for a in (real, fake, pr, pf)))
    np.testing.assert_array_equal(m2.numpy(), np.asarray(rm2))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(rt2))
