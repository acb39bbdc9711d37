"""The PyTorch port's sampling CLI, image writer and package rules (CPU)."""

import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multi_stylegan_tpu.io.logger import Logger
from multi_stylegan_tpu.io.torch_convert import export_reference_checkpoint
from multi_stylegan_tpu.models import Discriminator, Generator as JaxGenerator
from multi_stylegan_tpu.models.config import tiny_discriminator_config
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_config
from multi_stylegan_torch.cli import sample
from multi_stylegan_torch.io.from_jax import generator_state_from_jax
from multi_stylegan_torch.io.images import save_prediction
from multi_stylegan_torch.models.config import tiny_generator_config

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _expected_names(n):
    return sorted(f"sample_{i}_{d}_0.png" for i in range(n) for d in ("bf", "gfp"))


def test_cli_tiny_cpu_writes_the_sample_strips(tmp_path):
    out = tmp_path / "samples"
    run = sample.main(["--tiny", "--device", "cpu", "--samples", "3", "--batch_size", "2",
                       "--output", str(out), "--seed", "1"])
    assert run["samples"] == 3 and run["finite"]
    assert sorted(os.listdir(out)) == _expected_names(3)
    img = np.asarray(Image.open(out / "sample_2_gfp_0.png"))
    assert img.shape == (32, 96, 3) and img.dtype == np.uint8
    assert img[..., 0].max() == 0 and img[..., 2].max() == 0  # green tint only


def test_png_writer_matches_the_jax_logger(tmp_path, rng):
    pred = rng.uniform(-0.2, 1.2, size=(2, 2, 3, 8, 10)).astype(np.float32)
    log = Logger(experiment_path=str(tmp_path / "exp"))
    log.save_prediction(pred, "s")
    ours = tmp_path / "ours"
    ours.mkdir()
    save_prediction(pred, str(ours), "s")
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(tmp_path / "exp" / "plots"))
    for name in names:
        a = np.asarray(Image.open(ours / name))
        b = np.asarray(Image.open(tmp_path / "exp" / "plots" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_cli_loads_a_reference_checkpoint(tmp_path):
    """A .pt from the JAX package's exporter loads strictly, and what it
    holds is the EMA generator."""
    gcfg = jax_tiny_config()
    init = {"params": jax.random.key(0), "noise": jax.random.key(1),
            "mixing": jax.random.key(2)}
    v = jax.jit(JaxGenerator(gcfg).init)(init, jnp.zeros((1, gcfg.latent_dimensions)))
    ema = jax.tree.map(lambda a: np.asarray(a) + 0.5, v["params"])
    dcfg = tiny_discriminator_config()
    d_shapes = jax.eval_shape(Discriminator(dcfg).init, jax.random.key(3),
                              jnp.zeros((1, 2, 3, 32, 32)))["params"]
    d_params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), d_shapes)
    ckpt = export_reference_checkpoint(v["params"], v["noises"], ema, d_params,
                                       g_config=gcfg, d_config=dcfg)
    path = tmp_path / "checkpoint.pt"
    torch.save(ckpt, path)

    port = sample.load_generator(str(path), tiny_generator_config(), torch.device("cpu"))
    want = generator_state_from_jax(ema, jax.tree.map(np.asarray, v["noises"]),
                                    tiny_generator_config())
    got = port.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)

    out = tmp_path / "samples"
    run = sample.main(["--tiny", "--device", "cpu", "--samples", "1", "--checkpoint",
                       str(path), "--output", str(out)])
    assert run["finite"] and sorted(os.listdir(out)) == _expected_names(1)


def test_cli_needs_cuda_or_an_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        sample.main(["--tiny", "--samples", "1", "--output", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()
    # a directory is read as the port trainer's models directory
    with pytest.raises(FileNotFoundError, match="checkpoint_<step>.pt"):
        sample.main(["--tiny", "--device", "cpu", "--checkpoint", str(tmp_path),
                     "--output", str(tmp_path / "s")])


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither JAX, flax nor the JAX package."""
    files = sorted((REPO / "multi_stylegan_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "multi_stylegan_tpu")
    offenders = [
        (str(f.relative_to(REPO)), mod) for f in files for mod in _imported_modules(f)
        if mod.split(".")[0] in banned
    ]
    assert offenders == []
