"""The port's fft discriminator and ADA's sequential warps against the JAX
package's (CPU, tiny configs).

fft: weights cross through ``discriminator_state_from_jax`` (the first conv
18 channels wide at the no-RFP config); forward 1e-4 abs, the gradients
w.r.t. the input and the parameters 1e-3 of their peak (cuFFT's and
XLA's FFT sum in other orders; f32 both sides).  Sequential warps: the
port gets the JAX key schedule's draws; 1e-4 abs on images in [0, 1] and
1e-4 of the peak on the image gradient, as test_torch_port_ada.py holds
the composed warp.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.models import Discriminator as JaxDiscriminator
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.train import ada as jax_ada
from multi_stylegan_torch.io.from_jax import discriminator_state_from_jax
from multi_stylegan_torch.models.config import DiscriminatorConfig, tiny_discriminator_config
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.train import ada
from test_torch_port_ada import jax_draws


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny-config work: the suite
    runs several worker processes on a few cores, and more threads only
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _fft_pair():
    cfg = jax_tiny_d(fft=True)
    model = JaxDiscriminator(cfg)
    v = jax.jit(model.init)(jax.random.key(0), jnp.zeros((2, 2, 3, 32, 32)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32), v["params"])
    port = Discriminator(tiny_discriminator_config(fft=True))
    port.load_state_dict(discriminator_state_from_jax(params, tiny_discriminator_config(fft=True)),
                         strict=True)
    return model, params, port


def test_fft_first_conv_width():
    for kw, width in ((dict(), 6), (dict(fft=True), 18), (dict(fft=True, no_rfp=False), 27)):
        d = Discriminator(DiscriminatorConfig(**kw), device="meta")
        assert d.encoder_blocks[0].main_mapping[0].weight.shape[1] == width, kw
    _, params, port = _fft_pair()
    assert np.asarray(params["encoder_0"]["conv_0"]["weight"]).shape[2] == 18


def test_fft_discriminator_forward_matches_jax(rng):
    model, params, port = _fft_pair()
    x = rng.uniform(size=(3, 2, 3, 32, 32)).astype(np.float32)
    ref_s, ref_p = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        s, p = port(_t(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=0, atol=1e-4)


def test_fft_discriminator_gradients_match_jax(rng):
    """Input and parameter gradients of sum(scalar) + sum(pixel * w)."""
    model, params, port = _fft_pair()
    x = rng.uniform(size=(2, 2, 3, 32, 32)).astype(np.float32)
    w = rng.normal(size=(2, 1, 1, 32, 32)).astype(np.float32)

    def f(p, xx):
        s, pp = model.apply({"params": p}, xx)
        return jnp.sum(s) + jnp.sum(pp * w)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    s, pp = port(xt)
    names, tensors = zip(*port.named_parameters())
    grads = torch.autograd.grad(s.sum() + (pp * _t(w)).sum(), (xt,) + tensors)
    gx_ref = np.asarray(gx)
    assert np.abs(grads[0].numpy() - gx_ref).max() <= 1e-3 * np.abs(gx_ref).max()
    ref = discriminator_state_from_jax(jax.tree.map(np.asarray, gp),
                                       tiny_discriminator_config(fft=True))
    peak = max(float(ref[n].abs().max()) for n in names)
    for n, g in zip(names, grads[1:]):
        assert float((g - ref[n].reshape(g.shape)).abs().max()) <= 1e-3 * peak, n


@pytest.mark.parametrize("seed,p", [(0, 0.5), (1, 0.9), (2, 0.3)])
def test_sequential_warps_match_jax(rng, seed, p):
    """The four gated warps one after another with the JAX key schedule's
    draws, and the image gradient."""
    b, h, w, c = 6, 16, 16, 6
    x = rng.uniform(size=(b, h, w, c)).astype(np.float32)
    key = jax.random.key(seed)

    def f(a):
        return jax_ada.augmentation_pipeline(key, a, jnp.asarray(p), sequential_warps=True)

    ref = f(jnp.asarray(x))
    draws = jax_draws(key, b, h, w, p)
    assert draws.iso.any() and draws.rot1.any()
    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    got = ada.augmentation_pipeline(xt, draws, sequential_warps=True)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=0, atol=1e-4)
    # sequential and composed differ (four resamplings against one)
    composed = ada.augmentation_pipeline(xt, draws).detach()
    assert float((composed - got.detach()).abs().max()) > 1e-3
    cot = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ref_g = jax.grad(lambda a: jnp.sum(f(a) * cot))(jnp.asarray(x))
    (g,) = torch.autograd.grad((got * _t(cot.transpose(0, 3, 1, 2))).sum(), xt)
    np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(ref_g), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref_g)).max())


def test_sequential_p_zero_is_the_identity(rng):
    x = _t(rng.uniform(size=(4, 2, 3, 16, 16)).astype(np.float32))
    draws = ada.draw_ada(torch.Generator().manual_seed(0), 4, 16, 16, torch.tensor(0.0))
    torch.testing.assert_close(ada.augment_sequences(x, draws, sequential_warps=True), x,
                               rtol=0, atol=0)


def test_warp_resamples_in_f32_for_bf16_images(rng):
    """A bf16 image is resampled in f32 (the bilinear weights promote), as
    the JAX gather does: the same values as the f32 warp of the bf16 image."""
    x = _t(rng.uniform(size=(2, 6, 16, 16)).astype(np.float32)).bfloat16()
    inv = ada.scale_mat(torch.full((2, 2), 0.9)) @ ada.rot_mat(torch.tensor([30.0, -70.0]))
    got = ada.apply_affine_matrix(x, inv, "reflect")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ada.apply_affine_matrix(x.float(), inv, "reflect"),
                               rtol=0, atol=0)
