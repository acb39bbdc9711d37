"""The PyTorch port's generator against the JAX package's (CPU).

Weights cross through ``generator_state_from_jax``; wplus, noise and z are
drawn with numpy and handed to both.  The 256x256 config is checked for its
state-dict layout only: its forward pass is too slow for the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.io.torch_convert import export_generator
from multi_stylegan_tpu.models import Generator as JaxGenerator
from multi_stylegan_tpu.models.config import GeneratorConfig as JaxGeneratorConfig
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_config
from multi_stylegan_torch.io.from_jax import generator_state_from_jax
from multi_stylegan_torch.models.config import GeneratorConfig, tiny_generator_config
from multi_stylegan_torch.models.generator import Generator

# f32 on both sides; the convs sum in another order through 8 layers, with
# images of peak ~10 at these random weights.
ATOL = 1e-4
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _tiny_init(seed):
    """JAX init params of the tiny config with every leaf perturbed, so
    zero-initialised biases and noise weights carry signal too.  The wiring
    and compute-dtype fields do not change the params, so one init serves
    every variant."""
    cfg = jax_tiny_config()
    v = jax.jit(JaxGenerator(cfg).init)(
        {"params": jax.random.key(seed), "noise": jax.random.key(seed + 1),
         "mixing": jax.random.key(seed + 2)}, jnp.zeros((1, cfg.latent_dimensions)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32), v["params"])
    return params, jax.tree.map(np.asarray, v["noises"])


def _jax_variables(cfg, seed=0):
    params, noises = _tiny_init(seed)
    return JaxGenerator(cfg), params, noises


def _pair(compat=False, seed=0):
    jcfg = jax_tiny_config(compat_tower2_output_bug=compat)
    model, params, noises = _jax_variables(jcfg, seed)
    cfg = tiny_generator_config(compat_tower2_output_bug=compat)
    port = Generator(cfg)
    port.load_state_dict(generator_state_from_jax(params, noises, cfg), strict=True)
    return model, {"params": params, "noises": noises}, port.eval()


def _jax_synthesize(model, variables, wplus, noise):
    # jit: one XLA compile instead of one per op in eager mode
    run = jax.jit(lambda v, w, n: model.apply(v, w, n, method=JaxGenerator.synthesize))
    return np.asarray(run(variables, jnp.asarray(wplus), [jnp.asarray(n) for n in noise]))


def _nchw_noise(noise):
    return [torch.from_numpy(n.transpose(0, 3, 1, 2).copy()) for n in noise]


@pytest.mark.parametrize("compat", [False, True])
def test_synthesize_matches_jax(rng, compat):
    model, variables, port = _pair(compat)
    cfg = port.config
    b = 2
    wplus = rng.normal(size=(b, cfg.n_latents, cfg.latent_dimensions)).astype(np.float32)
    noise = [rng.normal(size=(b, h, w, 1)).astype(np.float32) for h, w in port._noise_shapes()]
    ref = _jax_synthesize(model, variables, wplus, noise)
    with torch.no_grad():
        got = port.synthesize(torch.from_numpy(wplus), _nchw_noise(noise))
    assert got.shape == (b, 2, 3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_synthesize_bf16_matches_jax(rng):
    """compute_dtype=bfloat16: activations in bf16, images returned in f32.
    The two frameworks round to bf16 at different places; 2% of the image's
    peak is a few bf16 ulps (the f32 image differs from either by as much)."""
    jcfg = jax_tiny_config(compute_dtype="bfloat16")
    model, params, noises = _jax_variables(jcfg)
    cfg = tiny_generator_config(compute_dtype="bfloat16")
    port = Generator(cfg)
    port.load_state_dict(generator_state_from_jax(params, noises, cfg), strict=True)
    wplus = rng.normal(size=(2, cfg.n_latents, cfg.latent_dimensions)).astype(np.float32)
    noise = [rng.normal(size=(2, h, w, 1)).astype(np.float32) for h, w in port._noise_shapes()]
    ref = _jax_synthesize(model, {"params": params, "noises": noises}, wplus, noise)
    with torch.no_grad():
        got = port.synthesize(torch.from_numpy(wplus), _nchw_noise(noise))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())


def test_compat_wiring_changes_the_image(rng):
    """The two wirings of the tower-2 output blocks differ (so the parity
    tests above do test the switch)."""
    _, _, plain = _pair(False)
    _, _, compat = _pair(True)
    z = torch.from_numpy(rng.normal(size=(1, 32)).astype(np.float32))
    with torch.no_grad():
        a = plain(z, randomize_noise=False)
        b = compat(z, randomize_noise=False)
    torch.testing.assert_close(a[:, 0], b[:, 0])
    assert float((a[:, 1] - b[:, 1]).abs().max()) > 1e-3


def test_map_latent_matches_jax(rng):
    model, variables, port = _pair()
    z = rng.normal(size=(4, 32)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(z), method=JaxGenerator.map_latent)
    with torch.no_grad():
        got = port.map_latent(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_forward_with_fixed_noise_matches_jax(rng):
    """z -> mapping -> wplus -> synthesis with the registered noise buffers."""
    model, variables, port = _pair()
    z = rng.normal(size=(2, 32)).astype(np.float32)
    ref = jax.jit(lambda v, z: model.apply(v, z, randomize_noise=False))(variables, jnp.asarray(z))
    with torch.no_grad():
        got = port(torch.from_numpy(z), randomize_noise=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_style_mixing_matches_jax(rng):
    model, variables, port = _pair()
    z1, z2 = (rng.normal(size=(2, 32)).astype(np.float32) for _ in range(2))
    idx = 3
    ref = jax.jit(lambda v, a, b: model.apply(
        v, a, b, inject_index=jnp.asarray(idx), randomize_noise=False, return_latents=True))(
        variables, jnp.asarray(z1), jnp.asarray(z2))
    with torch.no_grad():
        got, wplus = port(torch.from_numpy(z1), torch.from_numpy(z2), inject_index=idx,
                          randomize_noise=False, return_latents=True)
    np.testing.assert_allclose(wplus.numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    w = wplus.numpy()
    assert np.array_equal(w[:, 0], w[:, idx - 1]) and np.array_equal(w[:, idx], w[:, -1])
    with torch.no_grad():  # the same wplus handed in as a latent
        again = port(wplus, input_is_latent=True, randomize_noise=False)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_random_noise_shapes_and_generator(rng):
    _, _, port = _pair()
    a = port.random_noise(3, torch.Generator().manual_seed(5))
    b = port.random_noise(3, torch.Generator().manual_seed(5))
    assert [tuple(n.shape) for n in a] == [(3, 1, h, w) for h, w in port._noise_shapes()]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with torch.no_grad():
        img = port(torch.randn(3, 32), generator=torch.Generator().manual_seed(1))
    assert img.shape == (3, 2, 3, 32, 32) and torch.isfinite(img).all()


def test_state_from_jax_equals_the_jax_exporter():
    """The port's own layout transforms give exactly export_generator's dict."""
    cfg = jax_tiny_config()
    _, params, noises = _jax_variables(cfg)
    ours = generator_state_from_jax(params, noises, tiny_generator_config())
    ref = export_generator(params, noises, cfg)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_full_config_state_dict_layout():
    """At 256x256: the port's keys and shapes are export_generator's, and
    the parameter count is the JAX model's (shapes only, no forward)."""
    jcfg = JaxGeneratorConfig()
    shapes = jax.eval_shape(
        JaxGenerator(jcfg).init,
        {"params": jax.random.key(0), "noise": jax.random.key(1), "mixing": jax.random.key(2)},
        jnp.zeros((1, jcfg.latent_dimensions)))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    ref = export_generator(zeros["params"], zeros["noises"], jcfg)
    port = Generator(GeneratorConfig(), device="meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == {k: tuple(np.shape(v)) for k, v in ref.items()}
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    # buffers = noise maps + blur kernels, exactly the rest of the reference keys
    n_params = len(list(port.parameters()))
    assert n_params + len(list(port.buffers())) == len(ref)


def test_config_fields_match_jax():
    import dataclasses

    # the port's generator has three fields the JAX package's lacks (StyleGAN2,
    # config F); at their defaults they build the JAX package's network
    port_only = {"up_kernel_size": 2, "skip_upsample_gain": 1.0, "rgb_bias_per_channel": False}
    for port_cfg, jax_cfg in ((GeneratorConfig(), JaxGeneratorConfig()),
                              (tiny_generator_config(), jax_tiny_config())):
        assert dataclasses.asdict(port_cfg) == {**dataclasses.asdict(jax_cfg), **port_only}
        for prop in ("stage_channels", "n_stages", "n_latents", "resolution"):
            assert getattr(port_cfg, prop) == getattr(jax_cfg, prop)
