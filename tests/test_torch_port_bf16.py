"""bf16 training in the port against the JAX package's (CPU, tiny configs).

The D, G and cut-mix sub-steps at ``compute_dtype="bfloat16"`` on both
sides, from the same weights and draws (test_torch_port_train.py's
bridge).  The two bf16 paths round at other points: the JAX package's
default ops on the CPU are its XLA versions, which add the bias and apply
the slope in bf16, while the port's plain K1 computes in f32 and rounds
once.  So a fixed tight tolerance would be arbitrary; each quantity is held
to one that calibrates itself on the bf16 error itself:

    max |port_bf16 - jax_bf16| <= max(4 max |jax_bf16 - f32|, 2^-8 peak)

over the quantity (the images, a loss, all of a model's parameter
gradients), peak = max |f32|.  The f32 side is the port's f32 sub-step on
the same state and draws, which test_torch_port_train.py holds to the JAX
f32 sub-step within 1e-4 of the peak (a thousandth of the bf16 distances
here), so each sub-step needs one JAX compile, not two.  Measured here,
the port's distance to JAX's bf16 is 0.18 to 1.25 of JAX's bf16-to-f32
distance (the bound allows 4).

R1 and path length must run in f32 under a bf16 config (JAX steps.py:
88-100): forward hooks on every module of G and D see only f32
activations inside ``r1_update`` and ``path_length_update``, and bf16 ones
in the D and G steps of the same state.  The K1 and K3 sites of a bf16
forward and backward see bf16 tensors, whose upfirdn2d plan is held in
test_torch_port_upfirdn_plan.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.models import Discriminator as JaxDiscriminator
from multi_stylegan_tpu.models import Generator as JaxGenerator
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_g
from multi_stylegan_tpu.train.steps import StepFlags as JaxStepFlags
from multi_stylegan_tpu.train.steps import make_train_step
from multi_stylegan_torch.io.from_jax import train_state_from_jax
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.ops import fused_act
from multi_stylegan_torch.ops import upfirdn2d as up_mod
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.steps import StepFlags, TrainStep
from test_torch_port_train import (
    B,
    CFG_KW,
    ScriptedDraws,
    _cut_draw,
    _fake_draws,
    _jax_setup,
    _merge,
    _moments_by_name,
    _np_state,
    _real,
    _t,
)
from multi_stylegan_tpu.train.noise import random_permutation as jax_random_permutation


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny-config work: the suite
    runs several worker processes on a few cores, and more threads only
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

BF16 = dict(compute_dtype="bfloat16")


def self_calibrating(name, port, jax_bf16, jax_f32):
    """Assert the self-calibrating bound; returns the ratio of the port's
    distance to JAX's own bf16 error."""
    port, jb, jf = (np.asarray(a, np.float64) for a in (port, jax_bf16, jax_f32))
    err, own = float(np.abs(port - jb).max()), float(np.abs(jb - jf).max())
    limit = max(4 * own, 2.0 ** -8 * float(np.abs(jf).max()))
    assert np.isfinite(port).all() and err <= limit, (name, err, own, limit)
    return err / max(own, 1e-30)


@functools.lru_cache(maxsize=None)
def _jax_bf16_step():
    """The JAX sub-steps at bf16 on _jax_setup's state and train config."""
    _, _, cfg, _, _ = _jax_setup()
    g, d = JaxGenerator(jax_tiny_g(**BF16)), JaxDiscriminator(jax_tiny_d(**BF16))
    return make_train_step(g, d, cfg, top_k_start_iteration=0, top_k_final_iteration=4)


def _port_state(dtype="bfloat16"):
    _, _, _, jstate, _ = _jax_setup()
    kw = dict(compute_dtype=dtype)
    state = train_state_from_jax(_np_state(jstate), tiny_generator_config(**kw),
                                 tiny_discriminator_config(**kw), TrainingConfig(**CFG_KW))
    return state, TrainStep(TrainingConfig(**CFG_KW), top_k_start_iteration=0,
                            top_k_final_iteration=4)


def _flat_moments(port_module, opt, ref_by_name=None):
    """A model's first moments (the clipped gradients, b1 = 0) as one
    vector, in the port's parameter order."""
    names = {id(p): n for n, p in port_module.named_parameters()}
    if ref_by_name is None:
        return np.concatenate([m.detach().float().numpy().ravel() for m in opt.exp_avg])
    return np.concatenate([ref_by_name[names[id(p)]].numpy().ravel() for p in opt.params])


def _both_port_dtypes(run, draws):
    """``run(state, ts, draws)`` on the port's f32 and bf16 states, each with
    a fresh copy of the scripted draws: {dtype: (output, state)}."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        state, ts = _port_state(dtype)
        d = draws()
        out[dtype] = (run(state, ts, d), state)
        assert d.exhausted()
    return out


@pytest.fixture(scope="module")
def d_step_runs():
    _, _, _, jstate, _ = _jax_setup()
    real = _real()
    rng = jax.random.key(21)
    flags = JaxStepFlags(wrong_order=jnp.asarray(True), trap_weight=jnp.asarray(False),
                         do_cut_mix=jnp.asarray(False))
    ref = jax.jit(_jax_bf16_step().d_step)(jstate, jnp.asarray(real), flags, rng)
    k_fake, k_perm, _, _, _ = jax.random.split(rng, 5)
    perm = torch.from_numpy(np.asarray(jax_random_permutation(k_perm, 3)).astype(np.int64))
    port = _both_port_dtypes(lambda state, ts, d: ts.d_step(state, _t(real), True, d),
                             lambda: ScriptedDraws(**_merge(_fake_draws(k_fake, B),
                                                            dict(perm=[perm]))))
    return ref, port


def test_d_step_images_and_losses_bf16(d_step_runs):
    ref, port = d_step_runs
    (fakes, real_pp, fake_pp, losses), _ = port["bfloat16"]
    f32 = port["float32"][0]
    assert fakes.dtype == torch.float32  # the generator returns f32 images
    for i, (name, got) in enumerate((("fakes", fakes), ("real_pp", real_pp),
                                     ("fake_pp", fake_pp))):
        self_calibrating(name, got.numpy(), ref[1 + i], f32[i].numpy())
    for k, v in losses.items():
        self_calibrating(k, float(v), ref[4][k], float(f32[3][k]))


def test_d_step_gradient_bf16(d_step_runs):
    ref, port = d_step_runs
    (_, state), (_, state32) = port["bfloat16"], port["float32"]
    self_calibrating("D grads", _flat_moments(state.discriminator, state.d_opt),
                     _flat_moments(state.discriminator, state.d_opt,
                                   _moments_by_name(ref[0].d_opt_state, "d", None)),
                     _flat_moments(state32.discriminator, state32.d_opt))


def test_g_step_bf16():
    _, _, _, jstate, _ = _jax_setup()
    jstate = jstate.replace(step=jstate.step + 2)
    rng = jax.random.key(22)
    js, jm = jax.jit(_jax_bf16_step().g_step, static_argnums=1)(jstate, B, JaxStepFlags.off(), rng)
    k_fake, _ = jax.random.split(rng)

    def run(state, ts, draws):
        state.step = 2
        return ts.g_step(state, B, draws)

    port = _both_port_dtypes(run, lambda: ScriptedDraws(**_fake_draws(k_fake, B)))
    (metrics, state), (metrics32, state32) = port["bfloat16"], port["float32"]
    for k in ("loss_generator", "loss_generator_pixel_wise"):
        self_calibrating(k, float(metrics[k]), jm[k], float(metrics32[k]))
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    self_calibrating("G grads", _flat_moments(state.generator, state.g_opt),
                     _flat_moments(state.generator, state.g_opt,
                                   _moments_by_name(js.g_opt_state, "g", noises)),
                     _flat_moments(state32.generator, state32.g_opt))


def test_cut_mix_step_bf16():
    _, _, _, jstate, _ = _jax_setup()
    rng_np = np.random.default_rng(23)
    real, fakes = _real(5), _real(6)
    real_pp, fake_pp = (rng_np.normal(size=(B, 1, 1, 32, 32)).astype(np.float32) for _ in range(2))
    rng = jax.random.key(23)
    args = tuple(jnp.asarray(a) for a in (real, fakes, real_pp, fake_pp))
    js, jaug, jreg = jax.jit(_jax_bf16_step().cut_mix_step)(jstate, *args, rng)
    k1, k2 = jax.random.split(rng)
    inputs = tuple(_t(a) for a in (real, fakes, real_pp, fake_pp))
    port = _both_port_dtypes(lambda state, ts, d: ts.cut_mix_step(state, *inputs, d),
                             lambda: ScriptedDraws(cut=[_cut_draw(k1), _cut_draw(k2)]))
    (losses, state), (losses32, state32) = port["bfloat16"], port["float32"]
    for name, got, want, f32 in zip(("augmentation", "consistency"), losses, (jaug, jreg),
                                    losses32):
        self_calibrating(name, float(got), want, float(f32))
    self_calibrating("D grads (second update)", _flat_moments(state.discriminator, state.d_opt),
                     _flat_moments(state.discriminator, state.d_opt,
                                   _moments_by_name(js.d_opt_state, "d", None)),
                     _flat_moments(state32.discriminator, state32.d_opt))


class DtypeHooks:
    """Forward hooks on every module of the given models that record the
    dtypes of their floating-point outputs."""

    def __init__(self, *models):
        self.models, self.seen = models, set()

    def _hook(self, module, inputs, output):
        for t in output if isinstance(output, (tuple, list)) else (output,):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.seen.add((type(module).__name__, t.dtype))

    def __enter__(self):
        self.handles = [m.register_forward_hook(self._hook)
                        for model in self.models for m in model.modules()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def test_r1_and_path_length_run_in_f32_under_bf16():
    """Every activation of R1's and path length's passes is f32 (their
    recomputes under remat included); the D and G steps of the same bf16
    state run bf16 blocks."""
    state, ts = _port_state()
    assert state.generator.config.compute_dtype == "bfloat16"
    draws = TorchDraws(torch.Generator().manual_seed(0))
    real = _t(_real())
    models = (state.generator, state.discriminator)
    with DtypeHooks(*models) as main:
        ts.main_step(state, real, StepFlags(do_ema=False), draws)
    assert ("ResNetBlock", torch.bfloat16) in main.seen
    assert ("StyledConv2d", torch.bfloat16) in main.seen
    with DtypeHooks(*models) as r1:
        pen = ts.r1_update(state, real)
    with DtypeHooks(*models) as pl:
        pl_pen, length = ts.path_length_update(state, draws)
    for hooks, blocks in ((r1, {"ResNetBlock", "NonLocalBlock"}),
                          (pl, {"StyledConv2d", "OutputBlock"})):
        assert blocks <= {name for name, _ in hooks.seen}
        assert {dtype for _, dtype in hooks.seen} == {torch.float32}, hooks.seen
    assert all(np.isfinite(float(v)) for v in (pen, pl_pen, length))
    # one set of parameters: the f32 variants are the same modules
    assert all(p.dtype == torch.float32 for m in models for p in m.parameters())


def test_bf16_kernel_sites_see_bf16(monkeypatch):
    """A bf16 D and G step sends bf16 tensors to every K1 / K2 / K3 / K4
    call but the f32 mapping network (the style MLP maps f32 latents)."""
    seen = set()
    fwd, grad, upf = fused_act._forward, fused_act._grad, up_mod._upfirdn

    def rec(kind, fn):
        def run(x, *a, **kw):
            seen.add((kind, x.dtype, x.dim()))
            return fn(x, *a, **kw)
        return run

    monkeypatch.setattr(fused_act, "_forward", rec("K1", fwd))
    monkeypatch.setattr(fused_act, "_grad", rec("K2", grad))
    monkeypatch.setattr(up_mod, "_upfirdn", rec("K3/K4", upf))
    state, ts = _port_state()
    ts.main_step(state, _t(_real()), StepFlags(), TorchDraws(torch.Generator().manual_seed(1)))
    spatial = {(k, d) for k, d, n in seen if n == 4}
    assert spatial == {("K1", torch.bfloat16), ("K2", torch.bfloat16),
                       ("K3/K4", torch.bfloat16)}, seen
    # the mapping network maps f32 latents; D's scalar head runs in bf16
    assert {(k, d) for k, d, n in seen if n == 2} == {("K1", torch.float32),
                                                      ("K1", torch.bfloat16),
                                                      ("K2", torch.float32),
                                                      ("K2", torch.bfloat16)}, seen
