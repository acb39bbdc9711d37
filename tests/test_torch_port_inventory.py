"""The rest of the JAX package's inventory in the port, none of which the
trainer uses: the logger's TensorBoard writer, the elastic deformation, the
generator / Wasserstein / hinge losses and R2, and the transposed 2-D and
1-D equalized convs, each held against its JAX function on the same inputs
(f32: values and gradients within 1e-5 relative, R2's gradient of its
gradient within 1e-4 of its peak; the elastic field's sample points come
out of a 49-tap f32 sum, so the images within 1e-4).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.data import transforms as jax_transforms
from multi_stylegan_tpu.io.logger import Logger as JaxLogger
from multi_stylegan_tpu.nn.equalized import EqualizedConv1d as JaxConv1d
from multi_stylegan_tpu.nn.equalized import EqualizedTransposedConv2d as JaxTransposedConv2d
from multi_stylegan_tpu.train import losses as jax_losses
from multi_stylegan_torch.data import transforms
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.nn.equalized import EqualizedConv1d, EqualizedTransposedConv2d
from multi_stylegan_torch.train import losses


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


# ---------------------------------------------------------------- logger


def _scalars(directory):
    """(tag, step, value) of every scalar event under ``directory``, whether
    written as a scalar (torch) or as a tensor summary (tf.summary)."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util.tensor_util import make_ndarray

    acc = EventAccumulator(str(directory), size_guidance={"scalars": 0, "tensors": 0})
    acc.Reload()
    out = [(tag, e.step, e.value) for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)]
    out += [(tag, e.step, float(make_ndarray(e.tensor_proto)))
            for tag in acc.Tags()["tensors"] for e in acc.Tensors(tag)]
    return sorted(out)


def test_tensorboard_writer_matches_jax(tmp_path):
    """Each scalar at the step JAX gives it: the count of values logged
    under its name."""
    logs = [("loss_generator", 0.5), ("ada_p", 0.05), ("loss_generator", 0.25),
            ("loss_generator", 0.125), ("ada_p", 0.1)]
    for cls, name in ((Logger, "port"), (JaxLogger, "jax")):
        logger = cls(experiment_path=str(tmp_path / name), tensorboard=True)
        for k, v in logs:
            logger.log_metric(k, v)
        logger.save()
        (logger._tb_writer.close if name == "port" else logger._tb_writer.flush)()
    got = _scalars(tmp_path / "port" / "tensorboard")
    assert got == _scalars(tmp_path / "jax" / "tensorboard")
    assert got == [("ada_p", 1, 0.05000000074505806), ("ada_p", 2, 0.10000000149011612),
                   ("loss_generator", 1, 0.5), ("loss_generator", 2, 0.25),
                   ("loss_generator", 3, 0.125)]


def test_tensorboard_writer_is_off_by_default_and_silent_without_tensorboard(tmp_path,
                                                                            monkeypatch):
    assert Logger(experiment_path=str(tmp_path / "a"))._tb_writer is None
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    logger = Logger(experiment_path=str(tmp_path / "b"), tensorboard=True)
    assert logger._tb_writer is None
    logger.log_metric("x", 1.0)
    assert logger.metrics == {"x": [1.0]}


# ---------------------------------------------------------------- transforms


def test_gaussian_kernel_matches_jax():
    for sigma in (1, 3, 12):
        np.testing.assert_allclose(transforms.gaussian_kernel(sigma).numpy(),
                                   np.asarray(jax_transforms._gaussian_kernel(sigma)),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("alpha,sigma", [(50, 12), (80, 16), (4, 1)])
def test_elastic_deformation_matches_jax_on_its_draw(alpha, sigma):
    """The port given the displacement field JAX draws from its key."""
    key = jax.random.key(alpha)
    img = np.random.default_rng(sigma).uniform(size=(2, 3, 24, 20)).astype(np.float32)
    want = jax_transforms.elastic_deformation(key, jnp.asarray(img), alpha=alpha, sigma=sigma)
    kx, _ = jax.random.split(key)
    field = jax.random.uniform(kx, (2, 1, 24, 20), minval=-1.0, maxval=1.0)
    got = transforms.elastic_deformation(_t(img), alpha, sigma, displacement=_t(field))
    assert got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_elastic_deformation_module_draws_from_its_generator():
    img = torch.rand(3, 16, 16, generator=torch.Generator().manual_seed(0))
    deform = transforms.ElasticDeformation(alpha=8, sigma=2)
    a = deform(img, generator=torch.Generator().manual_seed(5))
    b = deform(img, generator=torch.Generator().manual_seed(5))
    c = deform(img, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c) and a.shape == img.shape
    assert torch.equal(deform(img, displacement=torch.zeros(2, 1, 16, 16)), img)


# -------------------------------------------------------------------- losses


def _inputs():
    rng = np.random.default_rng(3)
    return dict(real=rng.normal(size=(4, 1, 3, 6, 6)).astype(np.float32),
                fake=rng.normal(size=(4, 1, 3, 6, 6)).astype(np.float32),
                weight=rng.uniform(0.5, 2.0, size=(6, 6)).astype(np.float32),
                label=(rng.uniform(size=(4, 1, 3, 6, 6)) > 0.5).astype(np.float32))


LOSSES = {
    "non_saturating_generator": ("non_saturating_generator_loss", ("fake",)),
    "non_saturating_generator_weighted": ("non_saturating_generator_loss", ("fake", "weight")),
    "wasserstein_generator": ("wasserstein_generator_loss", ("fake",)),
    "wasserstein_generator_weighted": ("wasserstein_generator_loss", ("fake", "weight")),
    "wasserstein_discriminator": ("wasserstein_discriminator_loss", ("real", "fake")),
    "wasserstein_discriminator_weighted": ("wasserstein_discriminator_loss",
                                           ("real", "fake", "weight")),
    "wasserstein_cut_mix": ("wasserstein_discriminator_loss_cut_mix", ("real", "label")),
    "hinge_generator": ("hinge_generator_loss", ("fake",)),
    "hinge_discriminator": ("hinge_discriminator_loss", ("real", "fake")),
    "hinge_discriminator_weighted": ("hinge_discriminator_loss", ("real", "fake", "weight")),
    "hinge_cut_mix": ("hinge_discriminator_loss_cut_mix", ("real", "label")),
}


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_value_and_gradient_match_jax(case):
    name, args = LOSSES[case]
    inp = _inputs()
    diff = [a for a in args if a in ("real", "fake")]

    def total(out):  # the two terms of a pair weighted apart
        return out[0] + 2.0 * out[1] if isinstance(out, tuple) else out

    def jax_fn(*xs):
        vals = dict(zip(diff, xs))
        return total(getattr(jax_losses, name)(*[vals.get(a, jnp.asarray(inp[a]))
                                                 for a in args]))

    want, want_grads = jax.value_and_grad(jax_fn, argnums=tuple(range(len(diff))))(
        *[jnp.asarray(inp[a]) for a in diff])
    port_in = {a: _t(inp[a], grad=a in diff) for a in args}
    terms = getattr(losses, name)(*[port_in[a] for a in args])
    want_terms = getattr(jax_losses, name)(*[jnp.asarray(inp[a]) for a in args])
    for g, w in zip(*(t if isinstance(t, tuple) else (t,) for t in (terms, want_terms))):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5, atol=1e-7)
    got = total(terms)
    got_grads = torch.autograd.grad(got, [port_in[a] for a in diff])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-8)


def _d_fn(params, x, lib):
    """A two-headed toy D: scalar tanh((x . W) v), pixel x * a (only R1 reads it)."""
    flat = x.reshape(x.shape[0], -1)
    h = lib.tanh(flat @ params["w"])
    return (h @ params["v"]), x * params["a"]


def test_r2_penalty_value_gradient_and_gradient_of_gradient_match_jax():
    rng = np.random.default_rng(4)
    params = dict(w=rng.normal(size=(108, 5)).astype(np.float32) * 0.3,
                  v=rng.normal(size=(5, 1)).astype(np.float32),
                  a=np.float32(0.7))
    x = _inputs()["fake"]

    def jax_pen(p):
        return jax_losses.r2_penalty(lambda im: _d_fn(p, im, jnp), jnp.asarray(x))

    want, want_grads = jax.value_and_grad(jax_pen)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: _t(v, grad=True) for k, v in params.items()}
    pen = losses.r2_penalty(lambda im: _d_fn(tp, im, torch), _t(x))
    grads = torch.autograd.grad(pen, [tp["w"], tp["v"], tp["a"]], allow_unused=True)
    np.testing.assert_allclose(float(pen.detach()), float(want), rtol=1e-5)
    for g, k in zip(grads[:2], ("w", "v")):
        ref = np.asarray(want_grads[k])
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    # the pixel head does not enter R2: no gradient reaches its parameter
    assert grads[2] is None and float(want_grads["a"]) == 0.0
    # R1 through both heads differs from R2 on the same D
    r1 = losses.r1_penalty(lambda im: _d_fn(tp, im, torch), _t(x))
    assert float(r1.detach()) > float(pen.detach())


# --------------------------------------------------------- equalized layers


@pytest.mark.parametrize("k,stride,pad", [(2, 2, 0), (3, 2, 1), (4, 1, 1), (3, 3, 2)])
def test_equalized_transposed_conv2d_matches_jax(k, stride, pad):
    rng = np.random.default_rng(k * 10 + stride)
    cin, cout = 5, 3
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)  # JAX HWIO
    b = rng.normal(size=(cout,)).astype(np.float32)
    x = rng.normal(size=(2, 7, 6, cin)).astype(np.float32)   # NHWC
    want = JaxTransposedConv2d(cout, k, stride, pad).apply(
        {"params": {"weight": w, "bias": b}}, jnp.asarray(x))
    layer = EqualizedTransposedConv2d(cin, cout, k, stride, pad)
    assert torch.equal(layer.bias.detach(), torch.ones(cout))  # the reference's bias init of ones
    with torch.no_grad():
        layer.weight.copy_(_t(w.transpose(2, 3, 0, 1)))
        layer.bias.copy_(_t(b))
    got = layer(_t(x.transpose(0, 3, 1, 2))).detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (5, 2, 2), (1, 1, 0), (4, 3, 0)])
def test_equalized_conv1d_matches_jax(k, stride, pad):
    rng = np.random.default_rng(k * 10 + stride)
    cin, cout = 4, 6
    w = rng.normal(size=(k, cin, cout)).astype(np.float32)  # JAX WIO
    b = rng.normal(size=(cout,)).astype(np.float32)
    x = rng.normal(size=(3, 11, cin)).astype(np.float32)   # NWC
    want = JaxConv1d(cout, k, stride, pad).apply({"params": {"weight": w, "bias": b}},
                                                 jnp.asarray(x))
    layer = EqualizedConv1d(cin, cout, k, stride, pad)
    assert torch.equal(layer.bias.detach(), torch.ones(cout))
    with torch.no_grad():
        layer.weight.copy_(_t(w.transpose(2, 1, 0)))
        layer.bias.copy_(_t(b))
    got = layer(_t(x.transpose(0, 2, 1))).detach().numpy().transpose(0, 2, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
