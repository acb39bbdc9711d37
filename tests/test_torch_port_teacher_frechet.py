"""The teacher fixture, the stability script and the on-device Frechet
distance of the PyTorch port against the JAX package (CPU, tiny configs).

* ``TeacherTLFMDataset`` from the JAX teacher's weights (carried across by
  ``io/from_jax.py``) and the JAX draws of its latents and noise, in f32:
  within 1e-4 of the JAX dataset's samples (both in [0, 1]; f32 sums in
  other orders through 11 conv layers), every sample's channel min-max
  scaled exactly to 0 and 1 on both sides.
* ``frechet_distance_device`` at 64-dim activations: within 1e-4 relative
  of the JAX function (the same 30 f32 Newton-Schulz iterations), and of
  scipy's host value within twice the JAX function's own distance from it
  plus 1e-4 relative; both device functions give NaN without full rank.
* ``multi_stylegan_torch.tools.stability_run`` at the tiny config: 17 steps
  through ``Trainer.train`` (the lazy R1 and path length at step 16), a
  checkpoint at step 8 restored into other weights, and a JSON with the
  keys of the JAX record ``STABILITY_TEACHER.json``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.data.synthetic import TeacherTLFMDataset as JaxTeacher
from multi_stylegan_tpu.eval.frechet import frechet_distance_device as jax_frechet_device
from multi_stylegan_tpu.models import Generator as JaxGenerator
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_g
from multi_stylegan_torch.data.synthetic import TeacherTLFMDataset
from multi_stylegan_torch.eval.frechet import frechet_distance, frechet_distance_device
from multi_stylegan_torch.io.from_jax import generator_state_from_jax
from multi_stylegan_torch.models.config import tiny_generator_config
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.tools import stability_run

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_teacher_inputs(gen, seed, n_samples, batch):
    """The JAX teacher's variables and, per batch, the latents and noise it
    draws (JAX data/synthetic.py:95-113): the noise key is the first
    ``make_rng("noise")`` of the generator's call."""
    rngs = {"params": jax.random.key(seed), "noise": jax.random.key(seed + 1),
            "mixing": jax.random.key(seed + 2)}
    variables = jax.jit(lambda: gen.init(rngs, jnp.zeros((1, gen.config.latent_dimensions)),
                                         randomize_noise=False))()
    draws = []
    for i in range(-(-n_samples // batch)):
        kz, kn = jax.random.split(jax.random.fold_in(jax.random.key(seed + 3), i))
        z = jax.random.normal(kz, (batch, gen.config.latent_dimensions))
        k_noise = gen.apply(variables, method=lambda m: m.make_rng("noise"), rngs={"noise": kn})
        noise = gen.apply(variables, batch, k_noise, method=JaxGenerator.random_noise)
        draws.append((torch.from_numpy(np.asarray(z)),
                      [torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2)) for n in noise]))
    return variables, draws


def test_teacher_samples_match_jax(monkeypatch):
    seed, n, batch = 17, 6, 4  # two batches, the second cut to 2 samples
    jgen = JaxGenerator(jax_tiny_g())
    want = np.stack([x for x in JaxTeacher(n_samples=n, resolution=(32, 32), seed=seed,
                                           generator=jgen, batch=batch)])
    variables, draws = _jax_teacher_inputs(jgen, seed, n, batch)
    port = Generator(tiny_generator_config())
    port.load_state_dict(generator_state_from_jax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["noises"]), tiny_generator_config()))
    monkeypatch.setattr(TeacherTLFMDataset, "draw",
                        staticmethod(lambda index, b, generator, rng: draws[index]))
    data = TeacherTLFMDataset(n_samples=n, resolution=(32, 32), seed=seed, generator=port,
                              batch=batch)
    got = np.stack([data[i] for i in range(len(data))])
    assert got.shape == want.shape == (n, 2, 3, 32, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for x in (got, want):
        assert (x.min(axis=(2, 3, 4)) == 0).all() and (x.max(axis=(2, 3, 4)) == 1).all()


def test_teacher_default_generator_is_seeded():
    """Without a generator: a 512-channel one at the resolution, the same
    samples for the same seed."""
    a, b = (TeacherTLFMDataset(n_samples=2, resolution=(8, 8), batch=2, compute_dtype="float32")
            for _ in range(2))
    assert len(a) == 2 and np.array_equal(a[1], b[1]) and a[0].shape == (2, 3, 8, 8)
    with pytest.raises(ValueError, match="resolution"):
        TeacherTLFMDataset(n_samples=2, resolution=(16, 16), batch=2,
                           generator=Generator(tiny_generator_config(), device="meta"))


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_frechet_distance_device_matches_jax_and_scipy(shift):
    """Full-rank, well-conditioned covariances (1000 samples of 64 dims).
    The f32 iteration fails where C_real C_fake is near singular: with
    fewer samples than dims both device functions return NaN (the JAX one
    too), and near that edge each may diverge on inputs where the other's
    rounding happens to converge."""
    rng = np.random.default_rng(3)
    real = rng.normal(size=(1000, 64)) @ (np.eye(64) + rng.normal(size=(64, 64)) / 16)
    fake = (rng.normal(size=(1000, 64)) + shift) @ (np.eye(64) + rng.normal(size=(64, 64)) / 16)
    host = frechet_distance(real, fake)
    want = jax_frechet_device(real, fake)
    got = frechet_distance_device(torch.from_numpy(real), torch.from_numpy(fake))
    assert got == frechet_distance_device(real, fake)  # arrays go to the CPU
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert abs(got - host) <= 2 * abs(want - host) + 1e-4 * abs(host), (got, want, host)


def test_frechet_distance_device_needs_full_rank():
    rng = np.random.default_rng(4)
    real, fake = rng.normal(size=(48, 256)), rng.normal(size=(48, 256)) + 0.1
    assert np.isfinite(frechet_distance(real, fake))
    assert np.isnan(jax_frechet_device(real, fake)) and np.isnan(frechet_distance_device(real, fake))


def test_stability_run_tiny(tmp_path):
    out = tmp_path / "stability.json"
    report = stability_run.main(["--tiny", "--device", "cpu", "--dtype", "float32",
                                 "--batch", "4", "--steps", "17", "--out", str(out)])
    saved = json.loads(out.read_text())
    tpu = json.loads((REPO / "STABILITY_TEACHER.json").read_text())
    assert set(tpu) <= set(saved) and set(tpu["config"]) <= set(saved["config"])
    assert saved["events"] == ["checkpointed at step 8", "restored at step 8"]
    assert saved["final_step"] == 17 and saved["ok"] and saved["nan_steps"] == []
    assert saved["regularised_steps"] == [16]  # the lazy R1 and path length inside the loop
    assert [t["step"] for t in saved["trace"]] == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                                                   14, 15, 16, 17]
    assert set(saved["trace"][0]) == set(tpu["trace"][0])
    assert saved["config"]["fixture"] == "teacher" and report["seqs_per_sec"] > 0
