"""The PyTorch port's evaluation against the JAX package's (CPU, f32).

One random state dict per net, in the torchvision / pytorch-i3d layouts the
port's modules carry, feeds both sides (the JAX side through its
converters).  Nets: within 1e-4 of the output's peak (f32, other summation
orders).  Metrics: the same real batches, fakes and timestep indices (the
JAX metrics' draws, rebuilt from their key schedule) give the same FID, FVD
and IS within 1e-3 relative.  In the FID and FVD runs both sides' Frechet
distance is swapped for :func:`_frechet_low_rank`, the same number from an
SVD in sample space: scipy's ``sqrtm`` of a 2048 x 2048 product takes ~15 s
a call here, and the two packages' ``frechet_distance`` are held equal
directly.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_stylegan_tpu.eval import FID as JaxFID
from multi_stylegan_tpu.eval import FVD as JaxFVD
from multi_stylegan_tpu.eval import IS as JaxIS
from multi_stylegan_tpu.eval import frechet_distance as jax_frechet
from multi_stylegan_tpu.eval import normalize_m1_1_batch as jax_m1_1
from multi_stylegan_tpu.eval import resize_bilinear_antialias as jax_resize
from multi_stylegan_tpu.eval.i3d import InceptionI3D as JaxI3D, convert_pytorch_i3d
from multi_stylegan_tpu.eval.inception_v3 import InceptionV3 as JaxInception
from multi_stylegan_tpu.eval.inception_v3 import convert_torchvision_inception
from multi_stylegan_tpu.utils.image import normalize_0_1_batch as jax_0_1
from multi_stylegan_torch.eval.frechet import frechet_distance
from multi_stylegan_torch.eval.i3d import InceptionI3D, i3d_from_state_dict
from multi_stylegan_torch.eval.inception_v3 import InceptionV3, inception_from_state_dict
from multi_stylegan_torch.eval.metrics import FID, FVD, IS, WeightsUnavailable
from multi_stylegan_torch.models.config import tiny_generator_config
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.utils.image import (
    normalize_0_1_batch,
    normalize_m1_1_batch,
    resize_bilinear_antialias,
)

NET_TOL = 1e-4
METRIC_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(module, seed, fc_gain=3e3):
    """He-scaled conv weights and near-identity batch norms, so that the
    features still vary with the input 40 layers down; a large ``fc`` gain
    spreads the class softmax (IS is 1 when every image gets the same one)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                gain = fc_gain if name.startswith("fc.") else 2.0
                p.copy_(torch.randn(p.shape, generator=g) * (gain / p[0].numel()) ** 0.5)
            elif name.endswith("bn.weight"):
                p.copy_(1 + 0.05 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.1 * torch.rand(buf.shape, generator=g))
    return module.eval()


@functools.lru_cache(maxsize=None)
def _weights(tmp_dir):
    """Random Inception-v3 (with the aux head) and I3D (with logits) state
    dicts, saved as the pretrained files would be."""
    inc, i3d = _randomize(InceptionV3(), 1), _randomize(InceptionI3D(num_classes=400), 2)
    paths = (f"{tmp_dir}/inception.pt", f"{tmp_dir}/i3d.pt")
    torch.save(inc.state_dict(), paths[0])
    torch.save(i3d.state_dict(), paths[1])
    return paths


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _weights(str(tmp_path_factory.mktemp("eval_weights")))


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_close_to_peak(got, want, tol=NET_TOL):
    peak = float(np.abs(want).max())
    assert peak > 0
    assert float(np.abs(got - want).max()) <= tol * peak


# --------------------------------------------------------------------- nets


def test_inception_v3_equals_jax(weights):
    sd = _load(weights[0])
    port = inception_from_state_dict(sd)
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 3, 299, 299)).astype(np.float32)
    with torch.no_grad():
        pool = port(torch.from_numpy(x), features_only=True).numpy()
        logits = port(torch.from_numpy(x)).numpy()
    params = jax.tree.map(jnp.asarray, convert_torchvision_inception(sd))
    apply = jax.jit(JaxInception().apply, static_argnames="features_only")
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    assert pool.shape == (2, 2048) and logits.shape == (2, 1000)
    _assert_close_to_peak(pool, np.asarray(apply({"params": params}, xj, features_only=True)))
    _assert_close_to_peak(logits, np.asarray(apply({"params": params}, xj)))


def test_i3d_equals_jax_at_three_frames(weights):
    """T = 3 at 224²: Conv3d_1a_7x7's stride 2 meets an odd clip length."""
    sd = _load(weights[1])
    port = i3d_from_state_dict(sd)
    assert port.logits is not None
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, 3, 3, 224, 224)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    params = jax.tree.map(jnp.asarray, convert_pytorch_i3d(sd))
    want = np.asarray(jax.jit(JaxI3D().apply)({"params": params},
                                              jnp.asarray(x.transpose(0, 2, 3, 4, 1))))
    assert got.shape == (2, 1024)
    _assert_close_to_peak(got, want)


def test_state_dicts_load_strictly_with_and_without_the_extra_heads():
    for sd, load in ((InceptionV3(aux_logits=False).state_dict(), inception_from_state_dict),
                     (InceptionI3D().state_dict(), i3d_from_state_dict)):
        load(sd)
    with pytest.raises(RuntimeError, match="Missing key"):
        inception_from_state_dict({k: v for k, v in InceptionV3().state_dict().items()
                                   if not k.startswith("fc.")})


# ------------------------------------------------------------------ helpers


def test_normalize_and_resize_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(1.0, 5.0, size=(3, 2, 4, 4)).astype(np.float32)
    x[1] = 2.0  # a flat sample: 0/0 on both sides
    np.testing.assert_array_equal(normalize_m1_1_batch(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_m1_1(jnp.asarray(x))))
    np.testing.assert_array_equal(normalize_0_1_batch(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_0_1(jnp.asarray(x))))
    y = rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
    for size in ((299, 299), (224, 224), (17, 17)):
        got = resize_bilinear_antialias(torch.from_numpy(y), size).numpy()
        want = np.asarray(jax_resize(jnp.asarray(y.transpose(0, 2, 3, 1)), size))
        np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=1e-3, atol=2e-3)
    np.testing.assert_array_equal(
        resize_bilinear_antialias(torch.from_numpy(y), (17, 17)),
        F.interpolate(torch.from_numpy(y), size=(17, 17), mode="bilinear", antialias=True,
                      align_corners=False))


def _frechet_low_rank(a, b):
    """The Frechet distance of two activation sets through sample space:
    with centred rows X_a, X_b, tr sqrtm(C_a C_b) is the sum of the
    singular values of X_a X_b^T / sqrt((n_a - 1)(n_b - 1))."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    xa, xb = a - a.mean(0), b - b.mean(0)
    na, nb = len(a) - 1, len(b) - 1
    diff = a.mean(0) - b.mean(0)
    cross = np.linalg.svd(xa @ xb.T, compute_uv=False).sum() / np.sqrt(na * nb)
    return float(diff @ diff + (xa * xa).sum() / na + (xb * xb).sum() / nb - 2 * cross)


def test_frechet_distance_equals_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(60, 8)).astype(np.float32)
    b = (1.3 * rng.normal(size=(60, 8)) + 0.2).astype(np.float32)
    assert frechet_distance(a, b) == jax_frechet(a, b)
    assert abs(frechet_distance(a, a)) < 1e-5
    np.testing.assert_allclose(_frechet_low_rank(a, b), frechet_distance(a, b), rtol=1e-6)
    few, few_b = a[:6] * 3, b[:5]  # rank-deficient covariances, as in the metric runs below
    np.testing.assert_allclose(_frechet_low_rank(few, few_b), frechet_distance(few, few_b),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="feature widths"):
        frechet_distance(a, b[:, :4])


# ------------------------------------------------------------------ metrics

B, SAMPLES = 4, 8  # two batches of four, two domains


@functools.lru_cache(maxsize=None)
def _data():
    """Real batches, and fakes from the tiny generator with random weights."""
    rng = np.random.default_rng(4)
    real = [rng.uniform(size=(B, 2, 3, 32, 32)).astype(np.float32) for _ in range(2)]
    g = Generator(tiny_generator_config())
    g.reset_parameters(torch.Generator().manual_seed(5))
    with torch.no_grad():
        fakes = [g(torch.randn(B, 32, generator=torch.Generator().manual_seed(6 + i)),
                   generator=torch.Generator().manual_seed(9 + i)).numpy() for i in range(2)]
    return real, fakes


def _jax_timesteps(seed, n_batches, n_frames=3, n_domains=2):
    """Per batch the per-domain timesteps the JAX metric draws from
    ``jax.random.key(seed)`` (metrics.py:199-202, 278-280)."""
    rng, out = jax.random.key(seed), []
    for _ in range(n_batches):
        rng, kd = jax.random.split(rng)
        out.append([int(jax.random.randint(k, (), 0, n_frames))
                    for k in jax.random.split(kd, n_domains)])
    return out


def _feed_timesteps(metric, *schedules):
    queue = collections.deque(t for s in schedules for t in s)
    metric.draw_timesteps = lambda gen, n: torch.tensor(queue.popleft())
    return queue


def _appliers(fakes):
    """generator_apply for each side, handing out the same fakes in turn."""
    port_it, jax_it = iter(fakes), iter(fakes)
    return (lambda z, z2, gen: torch.from_numpy(next(port_it)),
            lambda z, z2, rng: jnp.asarray(next(jax_it)))


COMMON = dict(batch_size=B, data_samples=SAMPLES, latent_dimensions=32)


@pytest.fixture()
def fast_frechet(monkeypatch):
    from multi_stylegan_torch.eval import metrics as port_metrics
    from multi_stylegan_tpu.eval import metrics as jax_metrics

    monkeypatch.setattr(port_metrics, "frechet_distance", _frechet_low_rank)
    monkeypatch.setattr(jax_metrics, "frechet_distance", _frechet_low_rank)


def test_fid_equals_jax(weights, fast_frechet):
    real, fakes = _data()
    port = FID(inception_path=weights[0], device="cpu", **COMMON)
    queue = _feed_timesteps(port, _jax_timesteps(0, 2), _jax_timesteps(1, 2))
    ref = JaxFID(inception_path=weights[0], **COMMON)
    port_apply, jax_apply = _appliers(fakes)
    got = port(generator_apply=port_apply, dataset=iter(real))
    want = ref(generator_apply=jax_apply, dataset=[jnp.asarray(r) for r in real])
    assert not queue and len(got) == 2
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    for d in (0, 1):
        _assert_close_to_peak(port.activations_real[d], ref.activations_real[d])


def test_fvd_equals_jax(weights, fast_frechet):
    real, fakes = _data()
    port = FVD(i3d_path=weights[1], device="cpu", **COMMON)
    ref = JaxFVD(i3d_path=weights[1], **COMMON)
    port_apply, jax_apply = _appliers(fakes)
    got = port(generator_apply=port_apply, dataset=iter(real))
    want = ref(generator_apply=jax_apply, dataset=[jnp.asarray(r) for r in real])
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    for d in (0, 1):
        _assert_close_to_peak(port.activations_real[d], ref.activations_real[d])


def test_is_equals_jax(weights):
    _, fakes = _data()
    port = IS(inception_path=weights[0], device="cpu", **COMMON)
    queue = _feed_timesteps(port, _jax_timesteps(2, 2))
    ref = JaxIS(inception_path=weights[0], **COMMON)
    port_apply, jax_apply = _appliers(fakes)
    got = port(generator_apply=port_apply)
    want = ref(generator_apply=jax_apply)
    assert not queue and len(got) == 2 and all(s > 1.01 for s in got)
    # the mean KL divergence, of which IS is the exponential
    np.testing.assert_allclose(np.log(got), np.log(want), rtol=METRIC_RTOL)


def test_metrics_need_weights_and_read_the_environment(weights, monkeypatch):
    monkeypatch.delenv("MSG_TPU_INCEPTION_PT", raising=False)
    monkeypatch.delenv("MSG_TPU_I3D_PT", raising=False)
    for metric, var in ((FID, "MSG_TPU_INCEPTION_PT"), (IS, "MSG_TPU_INCEPTION_PT"),
                        (FVD, "MSG_TPU_I3D_PT")):
        with pytest.raises(WeightsUnavailable, match=var):
            metric(device="cpu")
    assert isinstance(IS(device="cpu", allow_random_weights=True).model, InceptionV3)
    monkeypatch.setenv("MSG_TPU_INCEPTION_PT", weights[0])
    fid = FID(device="cpu")
    want = inception_from_state_dict(_load(weights[0])).state_dict()
    for k, v in fid.model.state_dict().items():
        assert torch.equal(v, want[k]), k
