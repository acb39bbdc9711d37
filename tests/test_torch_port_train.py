"""The PyTorch port's training slice against the JAX package's (CPU, tiny configs).

Weights cross through ``*_state_from_jax``; every random draw of a JAX
sub-step is rebuilt from its key schedule (steps.py:117-137, 150-159,
244-245, 327-330) and handed to the port through a scripted provider, so
both sides see the same z, mixing, noise, permutation, cut-mix and probe
draws.  ADA runs at p = 0 here (identity; test_torch_port_ada.py covers the
warps).  Sub-steps are compared by their gradients: with b1 = 0 the first
Adam moment after one update IS the clipped gradient, on both sides, while
the parameters after Adam move by lr * sign(g), which flips on near-zero
entries.  Tolerances: values 1e-4 abs, gradients 1e-4 and grad-of-grad
(R1, path length) 1e-3 of the gradient's max abs (f32 on both sides, sums
in other orders).
"""

import collections
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.models import Discriminator as JaxDiscriminator
from multi_stylegan_tpu.models import Generator as JaxGenerator
from multi_stylegan_tpu.models.config import TrainingConfig as JaxTrainingConfig
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_g
from multi_stylegan_tpu.models.discriminator import binary_cut_mix_map as jax_cut_map
from multi_stylegan_tpu.train import losses as jax_losses
from multi_stylegan_tpu.train.noise import get_noise as jax_get_noise
from multi_stylegan_tpu.train.noise import random_permutation as jax_random_permutation
from multi_stylegan_tpu.train.state import (
    create_train_state,
    extract_adam_moments,
    make_generator_optimizer as jax_make_g_opt,
)
from multi_stylegan_tpu.train.steps import StepFlags as JaxStepFlags
from multi_stylegan_tpu.train.steps import make_train_step
from multi_stylegan_torch.cli import train as train_cli
from multi_stylegan_torch.io.from_jax import (
    discriminator_state_from_jax,
    generator_state_from_jax,
    train_state_from_jax,
)
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.train import losses
from multi_stylegan_torch.models.discriminator import binary_cut_mix_map
from multi_stylegan_torch.train.ada import draw_ada
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.state import make_generator_optimizer
from multi_stylegan_torch.train.steps import StepFlags, TrainStep

B = 4
CFG_KW = dict(batch_size=B, ada_p_init=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """JAX models, a train state with every parameter perturbed (zero-init
    biases, noise weights and NonLocal gammas carry signal) and ADA at p=0."""
    g, d = JaxGenerator(jax_tiny_g()), JaxDiscriminator(jax_tiny_d())
    cfg = JaxTrainingConfig(**CFG_KW)
    # jitted: the eager init dispatches op by op and takes ~3x as long
    state = jax.jit(lambda key: create_train_state(key, g, d, cfg))(jax.random.key(0))
    rng = np.random.default_rng(0)

    def perturb(tree):
        return jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32)), tree)

    g_params = perturb(state.g_params)
    state = state.replace(g_params=g_params, g_ema_params=g_params,
                          d_params=perturb(state.d_params))
    return g, d, cfg, state, make_train_step(g, d, cfg, top_k_start_iteration=0,
                                             top_k_final_iteration=4)


def _np_state(jstate):
    return jax.tree.map(np.asarray, jstate.replace(rng=None))


def _port_state():
    _, _, _, jstate, _ = _jax_setup()
    state = train_state_from_jax(
        _np_state(jstate), tiny_generator_config(), tiny_discriminator_config(),
        TrainingConfig(**CFG_KW))
    return state, TrainStep(TrainingConfig(**CFG_KW), top_k_start_iteration=0,
                            top_k_final_iteration=4)


class ScriptedDraws:
    """Hands out prepared draws per kind, in call order (ADA at p=0 from a
    CPU generator: every gate is off, so the values do not matter)."""

    def __init__(self, **queues):
        self.q = {k: collections.deque(v) for k, v in queues.items()}
        self.ada_gen = torch.Generator().manual_seed(0)

    def _pop(self, kind):
        return self.q[kind].popleft()

    def latents(self, batch, dim, p):
        return self._pop("latents")

    def inject_index(self, n):
        return self._pop("inject")

    def noise(self, batch, shapes):
        return self._pop("noise")

    def permutation(self, n):
        return self._pop("perm")

    def cut_mix(self, h, w):
        return self._pop("cut")

    def path_length_probe(self, shape):
        return self._pop("probe")

    def ada(self, batch, h, w, p):
        return draw_ada(self.ada_gen, batch, h, w, p)

    def exhausted(self):
        return all(len(v) == 0 for v in self.q.values())


def _wplus_draws(k_w, batch, p_mixed=0.9, dim=32, n_latents=8):
    kz, kmix = jax.random.split(k_w)
    z1, z2, use_mix = jax_get_noise(kz, batch, dim, p_mixed)
    inject = jax.random.randint(kmix, (), 1, n_latents - 1)
    return ((_t(z1), _t(z2), torch.tensor(bool(use_mix))), torch.tensor(int(inject)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_noise(k_n, batch, shapes):
    # one program for all layers: eager draws compile one per shape
    keys = jax.random.split(k_n, len(shapes))
    return [jax.random.normal(k, (batch, h, w, 1)) for k, (h, w) in zip(keys, shapes)]


def _noise_draws(k_n, batch):
    shapes = tuple(Generator(tiny_generator_config(), device="meta")._noise_shapes())
    return [_t(np.asarray(n).transpose(0, 3, 1, 2)) for n in _jax_noise(k_n, batch, shapes)]


def _fake_draws(k_fake, batch):
    k_w, k_n = jax.random.split(k_fake)
    lat, inj = _wplus_draws(k_w, batch)
    return dict(latents=[lat], inject=[inj], noise=[_noise_draws(k_n, batch)])


def _cut_draw(key, h=32, w=32):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return (int(jax.random.randint(k1, (), int(0.1 * h), int(0.9 * h))),
            int(jax.random.randint(k2, (), int(0.1 * w), int(0.9 * w))),
            bool(jax.random.uniform(k3, ()) > 0.5), bool(jax.random.uniform(k4, ()) > 0.5))


def _merge(*dicts):
    out = collections.defaultdict(list)
    for d in dicts:
        for k, v in d.items():
            out[k].extend(v)
    return out


def _moments_by_name(opt_state, kind, noises):
    mu = extract_adam_moments(opt_state)["mu"]
    if kind == "d":
        return discriminator_state_from_jax(jax.tree.map(np.asarray, mu), tiny_discriminator_config())
    return generator_state_from_jax(jax.tree.map(np.asarray, mu), noises, tiny_generator_config())


def _assert_grads_match(port_module, opt, ref_by_name, tol):
    names = {id(p): n for n, p in port_module.named_parameters()}
    peak = max(float(np.abs(ref_by_name[names[id(p)]].numpy()).max()) for p in opt.params)
    assert peak > 0
    for p, m in zip(opt.params, opt.exp_avg):
        ref = ref_by_name[names[id(p)]].numpy().reshape(m.shape)
        err = float(np.abs(m.numpy() - ref).max())
        assert err <= tol * peak, (names[id(p)], err, peak)


def _real(seed=1):
    return np.random.default_rng(seed).uniform(size=(B, 2, 3, 32, 32)).astype(np.float32)


# ----------------------------------------------------------------- (g) steps


@pytest.mark.parametrize("wrong_order", [False, True])
def test_d_step_gradients_match_jax(wrong_order):
    g, d, cfg, jstate, step_fn = _jax_setup()
    real = _real()
    rng = jax.random.key(11)
    flags = JaxStepFlags(wrong_order=jnp.asarray(wrong_order), trap_weight=jnp.asarray(False),
                         do_cut_mix=jnp.asarray(False))
    js, fakes, real_pp, fake_pp, jm = jax.jit(step_fn.d_step)(jstate, jnp.asarray(real), flags, rng)
    k_fake, k_perm, _, _, _ = jax.random.split(rng, 5)
    draws = ScriptedDraws(**_merge(_fake_draws(k_fake, B), dict(
        perm=[torch.from_numpy(np.asarray(jax_random_permutation(k_perm, 3)).astype(np.int64))])))
    state, ts = _port_state()
    p_fakes, p_real_pp, p_fake_pp, pm = ts.d_step(state, _t(real), wrong_order, draws)
    assert draws.exhausted()
    np.testing.assert_allclose(p_fakes.numpy(), _np(fakes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_real_pp.numpy(), _np(real_pp), rtol=0, atol=1e-4)
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-5, atol=1e-5, err_msg=k)
    _assert_grads_match(state.discriminator, state.d_opt,
                        _moments_by_name(js.d_opt_state, "d", None), 1e-4)
    np.testing.assert_allclose(float(state.ada.r_sum), float(js.ada.r_sum), atol=1e-6)


def test_g_step_gradients_match_jax():
    g, d, cfg, jstate, step_fn = _jax_setup()
    jstate = jstate.replace(step=jstate.step + 2)  # inside the top-k ramp
    rng = jax.random.key(12)
    js, jm = jax.jit(step_fn.g_step, static_argnums=1)(jstate, B, JaxStepFlags.off(), rng)
    k_fake, _ = jax.random.split(rng)
    draws = ScriptedDraws(**_fake_draws(k_fake, B))
    state, ts = _port_state()
    state.step = 2
    pm = ts.g_step(state, B, draws)
    assert draws.exhausted()
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-5, atol=1e-5, err_msg=k)
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    _assert_grads_match(state.generator, state.g_opt,
                        _moments_by_name(js.g_opt_state, "g", noises), 1e-4)


def test_r1_step_gradients_match_jax():
    g, d, cfg, jstate, step_fn = _jax_setup()
    real = _real(2)
    js, jpen, _ = jax.jit(step_fn.r1_step)(jstate, jnp.asarray(real))
    state, ts = _port_state()
    pen = ts.r1_step(state, _t(real))
    np.testing.assert_allclose(float(pen), float(jpen), rtol=1e-4)
    _assert_grads_match(state.discriminator, state.d_opt,
                        _moments_by_name(js.d_opt_state, "d", None), 1e-3)


def test_cut_mix_step_gradients_match_jax():
    g, d, cfg, jstate, step_fn = _jax_setup()
    rng_np = np.random.default_rng(3)
    real, fakes = _real(3), _real(4)
    real_pp, fake_pp = (rng_np.normal(size=(B, 1, 1, 32, 32)).astype(np.float32) for _ in range(2))
    rng = jax.random.key(13)
    js, jaug, jreg = jax.jit(step_fn.cut_mix_step)(
        jstate, *(jnp.asarray(a) for a in (real, fakes, real_pp, fake_pp)), rng)
    k1, k2 = jax.random.split(rng)
    cuts = [_cut_draw(k1), _cut_draw(k2)]
    np.testing.assert_array_equal(  # the port's map of the JAX draw is the JAX map
        _np(jax_cut_map(k1, 32, 32)), binary_cut_mix_map(cuts[0], 32, 32).numpy())
    draws = ScriptedDraws(cut=cuts)
    state, ts = _port_state()
    aug, reg = ts.cut_mix_step(state, *(_t(a) for a in (real, fakes, real_pp, fake_pp)), draws)
    np.testing.assert_allclose([float(aug), float(reg)], [float(jaug), float(jreg)], rtol=1e-4)
    # two updates: the moment holds the second (consistency) gradient,
    # taken after the first update on both sides
    _assert_grads_match(state.discriminator, state.d_opt,
                        _moments_by_name(js.d_opt_state, "d", None), 1e-3)


def test_path_length_step_gradients_match_jax():
    g, d, cfg, jstate, step_fn = _jax_setup()
    jstate = jstate.replace(mean_path_length=jnp.asarray(0.05, jnp.float32))
    rng = jax.random.key(14)
    js, jpen, jpl = jax.jit(step_fn.path_length_step, static_argnums=1)(jstate, B, rng)
    bs = B // 2
    k_w, k_n, k_pl = jax.random.split(rng, 3)
    lat, inj = _wplus_draws(k_w, bs)
    probe = _t(jax.random.normal(k_pl, (bs, 2, 3, 32, 32)))
    draws = ScriptedDraws(latents=[lat], inject=[inj], noise=[_noise_draws(k_n, bs)],
                          probe=[probe])
    state, ts = _port_state()
    state.mean_path_length = torch.tensor(0.05)
    pen, pl = ts.path_length_step(state, B, draws)
    assert draws.exhausted()
    np.testing.assert_allclose([float(pen), float(pl)], [float(jpen), float(jpl)], rtol=1e-4)
    np.testing.assert_allclose(float(state.mean_path_length), float(js.mean_path_length), rtol=1e-5)
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    _assert_grads_match(state.generator, state.g_opt,
                        _moments_by_name(js.g_opt_state, "g", noises), 1e-3)


def test_train_state_from_jax_carries_everything():
    _, _, _, jstate, _ = _jax_setup()
    jstate = jstate.replace(mean_path_length=jnp.asarray(0.25, jnp.float32))
    state = train_state_from_jax(_np_state(jstate), tiny_generator_config(),
                                 tiny_discriminator_config(), TrainingConfig(**CFG_KW))
    assert state.step == 0 and float(state.mean_path_length) == 0.25
    assert float(state.ada.p) == 0.0 and int(state.g_opt.count) == 0
    want = generator_state_from_jax(jax.tree.map(np.asarray, jstate.g_params),
                                    jax.tree.map(np.asarray, jstate.g_noises),
                                    tiny_generator_config())
    for k, v in state.generator.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    for k, v in state.g_ema.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


# ------------------------------------------------------- (c, d) regularizers


def test_r1_penalty_and_param_gradient_match_jax():
    _, d, _, jstate, _ = _jax_setup()
    real = _real(5)

    def pen_fn(params):
        return jax_losses.r1_penalty(lambda x: d.apply({"params": params}, x), jnp.asarray(real))

    jpen, jgrad = jax.jit(jax.value_and_grad(pen_fn))(jstate.d_params)
    port = Discriminator(tiny_discriminator_config())
    port.load_state_dict(discriminator_state_from_jax(
        jax.tree.map(np.asarray, jstate.d_params), tiny_discriminator_config()))
    pen = losses.r1_penalty(port, _t(real))
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(pen, params)
    ref = discriminator_state_from_jax(jax.tree.map(np.asarray, jgrad), tiny_discriminator_config())
    np.testing.assert_allclose(float(pen.detach()), float(jpen), rtol=1e-4)
    peak = max(float(ref[n].abs().max()) for n in names)
    for n, gr in zip(names, grads):
        assert float((gr - ref[n].reshape(gr.shape)).abs().max()) <= 1e-3 * peak, n


def test_path_length_penalty_and_param_gradient_match_jax():
    g, _, _, jstate, _ = _jax_setup()
    rng = np.random.default_rng(6)
    wplus = rng.normal(size=(2, 8, 32)).astype(np.float32)
    noise = [rng.normal(size=(2, h, w, 1)).astype(np.float32)
             for h, w in Generator(tiny_generator_config(), device="meta")._noise_shapes()]
    key = jax.random.key(7)
    probe = np.asarray(jax.random.normal(key, (2, 2, 3, 32, 32)))

    def pen_fn(params):
        synth = lambda wp: g.apply({"params": params, "noises": jstate.g_noises}, wp,
                                   [jnp.asarray(n) for n in noise], method=JaxGenerator.synthesize)
        grads = jax_losses.path_length_grads(synth, jnp.asarray(wplus), key)
        pen, pl, new_mean = jax_losses.path_length_penalty(grads, jnp.asarray(0.1), 0.01)
        return pen, (pl, new_mean)

    (jpen, (jpl, jmean)), jgrad = jax.jit(jax.value_and_grad(pen_fn, has_aux=True))(jstate.g_params)
    port = Generator(tiny_generator_config())
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    port.load_state_dict(generator_state_from_jax(
        jax.tree.map(np.asarray, jstate.g_params), noises, tiny_generator_config()))
    nchw = [_t(n.transpose(0, 3, 1, 2)) for n in noise]
    wp = _t(wplus).requires_grad_(True)
    grads_pl = losses.path_length_grads(lambda w: port.synthesize(w, nchw), wp, _t(probe))
    pen, pl, new_mean = losses.path_length_penalty(grads_pl, torch.tensor(0.1), 0.01)
    np.testing.assert_allclose([float(pen), float(pl), float(new_mean)],
                               [float(jpen), float(jpl), float(jmean)], rtol=1e-4)
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(pen, params, allow_unused=True)
    ref = generator_state_from_jax(jax.tree.map(np.asarray, jgrad), noises, tiny_generator_config())
    peak = max(float(ref[n].abs().max()) for n in names)
    for n, gr in zip(names, grads):
        gr = torch.zeros_like(ref[n]) if gr is None else gr
        assert float((gr - ref[n].reshape(gr.shape)).abs().max()) <= 1e-3 * peak, n


def test_top_k_matches_jax():
    pred = np.random.default_rng(8).normal(size=(24, 1)).astype(np.float32)
    pred[5] = pred[9]  # a tie, broken by index on both sides
    for it in (1, 7, 13, 40, 90, 100):
        v = losses.top_k_v(it, 10, 90)
        jv = jax_losses.top_k_v(jnp.asarray(it, jnp.int32), 10, 90)
        assert v == float(jv), it
        mask, k = losses.top_k_mask(_t(pred), v)
        jmask, jk = jax_losses.top_k_mask(jnp.asarray(pred), jv)
        assert k == float(jk)
        np.testing.assert_array_equal(mask.numpy(), _np(jmask))


# ----------------------------------------------------------- (f) optimizer


def test_generator_optimizer_matches_optax():
    """One clipped update (||g|| > 5), then a non-finite step that must be
    skipped (params, moments, count untouched), then one more update."""
    _, _, _, jstate, _ = _jax_setup()
    cfg_j, cfg = JaxTrainingConfig(), TrainingConfig()
    params = jstate.g_params
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    opt = jax_make_g_opt(cfg_j)
    opt_state = opt.init(params)
    port = Generator(tiny_generator_config())
    port.load_state_dict(generator_state_from_jax(jax.tree.map(np.asarray, params), noises,
                                                  tiny_generator_config()))
    popt = make_generator_optimizer(port, cfg)
    names = {id(p): n for n, p in port.named_parameters()}
    rng = np.random.default_rng(9)
    for i, bad in enumerate((False, True, False)):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
                             params)
        if bad:
            grads["style_mapping"]["act_0"]["bias"] = grads["style_mapping"]["act_0"]["bias"].at[0].set(jnp.nan)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        by_name = generator_state_from_jax(jax.tree.map(np.asarray, grads), noises,
                                           tiny_generator_config())
        applied = popt.step([by_name[names[id(p)]].reshape(p.shape) for p in popt.params])
        assert bool(applied) == (not bad)
        want = generator_state_from_jax(jax.tree.map(np.asarray, params), noises,
                                        tiny_generator_config())
        for n, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy().reshape(p.shape),
                                       rtol=0, atol=1e-6, err_msg=f"{n} after update {i}")
        assert int(popt.count) == int(extract_adam_moments(opt_state)["count"])


# ------------------------------------------------------------ (h) remat


def test_grad_of_grad_through_checkpointed_blocks_equals_plain():
    """R1 through D and path length through G: the same parameter gradients
    with the blocks rematerialized (torch.utils.checkpoint) and without."""
    results = []
    for remat in (True, False):
        torch.manual_seed(0)
        d = Discriminator(tiny_discriminator_config(remat=remat))
        d.reset_parameters(torch.Generator().manual_seed(1))
        with torch.no_grad():
            for m in d.modules():
                if hasattr(m, "gamma"):
                    m.gamma.fill_(0.7)
        g = Generator(tiny_generator_config(remat=remat))
        g.reset_parameters(torch.Generator().manual_seed(2))
        real = _t(_real(10))
        gd = torch.autograd.grad(losses.r1_penalty(d, real), list(d.parameters()))
        wp = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(3)).requires_grad_(True)
        noise = g.random_noise(2, torch.Generator().manual_seed(4))
        probe = torch.randn(2, 2, 3, 32, 32, generator=torch.Generator().manual_seed(5))
        pen, _, _ = losses.path_length_penalty(
            losses.path_length_grads(lambda w: g.synthesize(w, noise), wp, probe),
            torch.tensor(0.0))
        gg = torch.autograd.grad(pen, list(g.parameters()), allow_unused=True)
        results.append((gd, gg))
    for a, b in zip(results[0][0] + results[0][1], results[1][0] + results[1][1]):
        if a is None or b is None:
            assert a is None and b is None
            continue
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- (i) the CLI


def test_cli_train_tiny_cpu(tmp_path):
    """16 steps of batch 4 (64 fixture sequences): step 16 runs R1 and path length."""
    run = train_cli.main(["--tiny", "--synthetic", "--device", "cpu", "--epochs", "1",
                          "--batch_size", "4", "--seed", "3",
                          "--experiment_path", str(tmp_path / "exp")])
    assert run["steps"] == 16 and run["finite"]
    last = run["history"][-1]
    assert last["loss_discriminator_regularization"] > 0 and last["path_length"] > 0
    assert all(m["loss_discriminator_regularization"] == 0 for m in run["history"][:-1])
    state = run["state"]
    assert state.step == 16 and math.isfinite(float(state.mean_path_length))


def test_cli_train_needs_synthetic_and_cuda_or_cpu(monkeypatch, tmp_path):
    """Without --synthetic the CLI reads --path_to_data, which must exist."""
    with pytest.raises(FileNotFoundError, match="synthetic"):
        train_cli.main(["--tiny", "--device", "cpu", "--path_to_data", str(tmp_path / "none")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--tiny", "--synthetic"])


def test_main_step_flags_and_ema():
    """main_step runs cut-mix only when asked and skips the EMA when told."""
    state, ts = _port_state()
    draws_gen = TorchDraws(torch.Generator().manual_seed(0))
    ema_before = [p.clone() for p in state.g_ema.parameters()]
    m = ts.main_step(state, _t(_real()), StepFlags(wrong_order=True, do_cut_mix=True,
                                                   do_ema=False), draws_gen)
    assert float(m["loss_cut_mix_augmentation"]) > 0 and state.step == 1
    assert all(torch.equal(a, b) for a, b in zip(ema_before, state.g_ema.parameters()))
    m = ts.main_step(state, _t(_real()), StepFlags(), draws_gen)
    assert float(m["loss_cut_mix_augmentation"]) == 0
    assert not all(torch.equal(a, b) for a, b in zip(ema_before, state.g_ema.parameters()))


# ------------------------------------------- launch counts of chip_smoke.py


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("remat", [True, False])
def test_launch_formula_matches_counted_dispatches(remat, monkeypatch):
    """chip_smoke.py asserts each sub-step's K1-K4 launches on the card from
    a formula over the models' structure; on the CPU the same dispatches
    reach the plain versions, counted here, at the tiny config."""
    from multi_stylegan_torch.ops import fused_act
    from multi_stylegan_torch.ops import upfirdn2d as up_mod

    counts = collections.Counter()
    fwd, grad, upf = fused_act._forward, fused_act._grad, up_mod._upfirdn

    def count(kind, fn):
        def run(*a, **kw):
            counts[kind(*a, **kw) if callable(kind) else kind] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(fused_act, "_forward", count("K1", fwd))
    monkeypatch.setattr(fused_act, "_grad", count("K2", grad))
    monkeypatch.setattr(up_mod, "_upfirdn", count(
        lambda *a, adjoint=False: "K4" if (adjoint or (len(a) > 5 and a[5])) else "K3", upf))
    gcfg, dcfg = tiny_generator_config(remat=remat), tiny_discriminator_config(remat=remat)
    g, d = Generator(gcfg), Discriminator(dcfg)
    g.reset_parameters(torch.Generator().manual_seed(0))
    d.reset_parameters(torch.Generator().manual_seed(1))
    cfg = TrainingConfig(batch_size=B)
    from multi_stylegan_torch.train.state import create_train_state as create

    state, ts = create(g, d, cfg), TrainStep(cfg, top_k_start_iteration=0, top_k_final_iteration=4)
    draws = TorchDraws(torch.Generator().manual_seed(2))
    real = _t(_real())
    expected = _chip_smoke().expected_launches
    runs = [("d_step", True, lambda: ts.d_step(state, real, True, draws)),
            ("d_step", False, lambda: ts.d_step(state, real, False, draws)),
            ("cut_mix_step", False, lambda: ts.cut_mix_step(
                state, real, real.flip(0), real[:, :1, :1], real[:, :1, :1], draws)),
            ("g_step", False, lambda: ts.g_step(state, B, draws)),
            ("r1_update", False, lambda: ts.r1_update(state, real)),
            ("path_length_update", False, lambda: ts.path_length_update(state, draws))]
    for name, wrong, run in runs:
        counts.clear()
        run()
        assert dict(counts) == expected(gcfg, dcfg, name, wrong_order=wrong), (name, wrong)
