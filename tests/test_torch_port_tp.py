"""Tensor parallelism of the PyTorch port (parallel/tensor.py, the model axis
of parallel/mesh.py) on the CPU, at the JAX package's own TP test config
(tests/test_parallel.py:179-185) and global batch 8.

* The sharding rule, without spawning: the port's sharded leaves are the
  ones the JAX ``state_shardings`` shards in JAX's own state (shapes only),
  at that config, the tiny config and the flagship, with a model axis of 2
  and of 4.
* One spawn of (data 1, model 2) and one of (data 2, model 2) gloo ranks
  (a module fixture; ``file://`` rendezvous in the test's own directory):
  - (1, 2) only: a two-layer conv stack's value, input gradient, parameter
    gradient and the gradient of its squared input gradient (R1's form);
    the fft discriminator's gradients in bf16;
  - one main step (wrong order, cut-mix, top-k), R1 and the path-length
    update through the Trainer's ladder, from a JAX state carried across
    and the JAX key schedule's draws; every update's gradients and the Adam
    moments after each stage, gathered whole;
  - each rank's bytes of the sharded leaves and their moments and EMA;
  - a checkpoint of the sharded state (the one-process layout, rank 0
    writes) and the restore of a one-process checkpoint into it.

Meanwhile this process runs the JAX step and the port's one-process step on
the same inputs.  Tolerances: gradients within 1e-5 of their peak against
one process and within 1e-4 / 1e-3 of the peak against JAX (the port's
parity tolerances, tests/test_torch_port_train.py); metrics 1e-5 relative
against one process and 1e-4 against JAX; replicated leaves the same bits
on every rank; checkpoints bitwise.
"""

import functools
import multiprocessing
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_stylegan_tpu.models import Discriminator as JaxDiscriminator
from multi_stylegan_tpu.models import Generator as JaxGenerator
from multi_stylegan_tpu.models.config import DiscriminatorConfig as JaxDiscriminatorConfig
from multi_stylegan_tpu.models.config import GeneratorConfig as JaxGeneratorConfig
from multi_stylegan_tpu.models.config import TrainingConfig as JaxTrainingConfig
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_g
from multi_stylegan_tpu.parallel import make_mesh, state_shardings
from multi_stylegan_tpu.train.noise import get_noise as jax_get_noise
from multi_stylegan_tpu.train.noise import random_permutation as jax_random_permutation
from multi_stylegan_tpu.train.state import create_train_state, extract_adam_moments
from multi_stylegan_tpu.train.steps import StepFlags as JaxStepFlags
from multi_stylegan_tpu.train.steps import make_train_step
from multi_stylegan_torch.io.checkpoint import (
    load_train_state,
    train_state_dict,
)
from multi_stylegan_torch.io.from_jax import (
    discriminator_state_from_jax,
    generator_state_from_jax,
    train_state_from_jax,
)
from multi_stylegan_torch.models.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.nn.equalized import EqualizedConv2d, FusedLeakyReLU
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.parallel import tensor as tp
from multi_stylegan_torch.train.draws import ShardDraws
from multi_stylegan_torch.train.robust import RobustPathLength
from multi_stylegan_torch.train.state import create_train_state as port_create_train_state
from multi_stylegan_torch.train.steps import StepFlags, TrainStep
from test_torch_port_train import ScriptedDraws, _cut_draw, _jax_noise, _merge, _t

G_KW = dict(channels=(16, 16, 16), latent_dimensions=16, depth_style_mapping=1)
D_KW = dict(encoder_channels=((3, 8), (8, 12), (12, 16)), decoder_channels=((16, 12), (12, 8)))
GCFG, DCFG = tiny_generator_config(**G_KW), tiny_discriminator_config(**D_KW)
RES = GCFG.resolution[0]  # 16
B = 8
CFG_KW = dict(batch_size=B, ada_p_init=0.0)
LAYOUTS = {"d1m2": (1, 2), "d2m2": (2, 2)}
TIMEOUT_S = 170  # each spawn; a hung collective fails the test instead of the suite's clock
FLAGS = dict(wrong_order=True, trap_weight=False, do_cut_mix=True, do_ema=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------- the sharding rule


def _jax_marked(tree):
    """``tree`` with each leaf a size-1 array of its ndim holding the leaf's
    index, and the leaves' paths by index."""
    paths = {}

    def mark(path, leaf):
        paths[len(paths)] = jax.tree_util.keystr(path)
        return np.full((1,) * len(leaf.shape), len(paths) - 1, np.float32)
    return jax.tree_util.tree_map_with_path(mark, tree), paths


def _port_names(jax_params, to_port):
    """JAX path -> the port's state-dict key of each parameter leaf (through
    io/from_jax.py's name map, on marker arrays)."""
    marked, paths = _jax_marked(jax_params)
    return {paths[int(v.reshape(-1)[0])]: k for k, v in to_port(marked).items()
            if not k.endswith("kernel") and not k.startswith("noises.")}


CONFIGS = {
    "tp_test": ((jax_tiny_g(**G_KW), jax_tiny_d(**D_KW)), (GCFG, DCFG)),
    "tiny": ((jax_tiny_g(), jax_tiny_d()), (tiny_generator_config(), tiny_discriminator_config())),
    "flagship": ((JaxGeneratorConfig(), JaxDiscriminatorConfig(no_rfp=True)),
                 (GeneratorConfig(), DiscriminatorConfig(no_rfp=True))),
}


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_sharded_leaves_are_the_ones_jax_shards(config, n_model):
    """JAX's ``state_shardings`` on JAX's own state (``eval_shape``: no
    weights made) against the port's ``shard_plan`` on meta-device models:
    the same parameters, and in JAX their EMA mirrors and both Adam moments
    follow."""
    (jg, jd), (pg, pd) = CONFIGS[config]
    state = jax.eval_shape(lambda k: create_train_state(k, JaxGenerator(jg), JaxDiscriminator(jd),
                                                        JaxTrainingConfig()),
                           jax.random.key(0))
    shardings = state_shardings(make_mesh(n_data=1, n_model=n_model), state)

    def sharded(tree):
        return {jax.tree_util.keystr(p) for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]
                if s.spec != jax.sharding.PartitionSpec()}

    g_names = _port_names(state.g_params, lambda t: generator_state_from_jax(
        t, _jax_marked(state.g_noises)[0], pg))
    d_names = _port_names(state.d_params, lambda t: discriminator_state_from_jax(t, pd))
    want_g = {g_names[p] for p in sharded(shardings.g_params)}
    want_d = {d_names[p] for p in sharded(shardings.d_params)}
    assert want_g and want_d
    assert set(tp.shard_plan(Generator(pg, device="meta"), n_model)) == want_g
    assert set(tp.shard_plan(Discriminator(pd, device="meta"), n_model)) == want_d
    assert sharded(shardings.g_ema_params) == sharded(shardings.g_params)
    n_opt = len(sharded(shardings.g_opt_state)) + len(sharded(shardings.d_opt_state))
    assert n_opt == 2 * (len(want_g) + len(want_d))
    # the output blocks' 3-channel convs and every bias stay replicated
    assert not any("output_block" in n or n.endswith("bias") for n in want_g | want_d)


# ------------------------------------------------------------- spawning


def _rank_entry(rank, world, n_model, init_method, fn_name, args):
    torch.set_num_threads(1)
    mesh.init(world, rank, init_method, torch.device("cpu"), timeout_s=TIMEOUT_S,
              n_model=n_model)
    try:
        globals()[fn_name](*args)
    finally:
        mesh.shutdown()


def spawn(fn_name, rendezvous, n_data, n_model, args=()):
    """Start the ranks of a (``n_data``, ``n_model``) mesh running
    ``fn_name(*args)``, meeting at the file ``rendezvous``; returns a join
    function that waits at most ``TIMEOUT_S`` from now and fails on a rank's
    non-zero exit or a hang (killing the ranks)."""
    ctx = multiprocessing.get_context("spawn")
    world = n_data * n_model
    init = f"file://{rendezvous}"
    procs = [ctx.Process(target=_rank_entry, args=(r, world, n_model, init, fn_name, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S

    def join():
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [p.pid for p in procs if p.is_alive()]
            assert not hung, f"ranks {hung} still running after {TIMEOUT_S} s"
            assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return join


# ------------------------------------------------------------- the inputs


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """JAX models at the TP test config, a train state with every parameter
    perturbed and ADA at p = 0 (as test_torch_port_train.py's), and its step."""
    g, d = JaxGenerator(jax_tiny_g(**G_KW)), JaxDiscriminator(jax_tiny_d(**D_KW))
    cfg = JaxTrainingConfig(**CFG_KW)
    state = jax.jit(lambda key: create_train_state(key, g, d, cfg))(jax.random.key(3))
    rng = np.random.default_rng(3)

    def perturb(tree):
        return jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32)), tree)

    g_params = perturb(state.g_params)
    state = state.replace(g_params=g_params, g_ema_params=g_params,
                          d_params=perturb(state.d_params))
    return state, make_train_step(g, d, cfg, top_k_start_iteration=0, top_k_final_iteration=4)


def _np_state(jstate):
    return jax.tree.map(np.asarray, jstate.replace(rng=None))


def _wplus_draws(k_w, batch):
    kz, kmix = jax.random.split(k_w)
    z1, z2, use_mix = jax_get_noise(kz, batch, GCFG.latent_dimensions, 0.9)
    inject = jax.random.randint(kmix, (), 1, GCFG.n_latents - 1)
    return ((_t(z1), _t(z2), torch.tensor(bool(use_mix))), torch.tensor(int(inject)))


def _noise_draws(k_n, batch):
    shapes = tuple(Generator(GCFG, device="meta")._noise_shapes())
    return [_t(np.asarray(n).transpose(0, 3, 1, 2)) for n in _jax_noise(k_n, batch, shapes)]


def _fake_draws(k_fake, batch):
    k_w, k_n = jax.random.split(k_fake)
    lat, inj = _wplus_draws(k_w, batch)
    return dict(latents=[lat], inject=[inj], noise=[_noise_draws(k_n, batch)])


def _step_draws(jstate):
    """The global draws of the JAX main step at step 1 and of the
    path-length update after it, rebuilt from the state's key schedule
    (JAX steps.py:426-431, 508-509)."""
    base = jax.random.fold_in(jstate.rng, 1)
    k_d, k_cm, k_g, _ = jax.random.split(base, 4)
    k_fake, k_perm, _, _, _ = jax.random.split(k_d, 5)
    perm = torch.from_numpy(np.asarray(jax_random_permutation(k_perm, 3)).astype(np.int64))
    k1, k2 = jax.random.split(k_cm)
    k_gf, _ = jax.random.split(k_g)
    main = _merge(_fake_draws(k_fake, B),
                  dict(perm=[perm], cut=[_cut_draw(k1, RES, RES), _cut_draw(k2, RES, RES)]),
                  _fake_draws(k_gf, B))
    k_w, k_n, k_pl = jax.random.split(jax.random.fold_in(base, 17), 3)
    lat, inj = _wplus_draws(k_w, B // 2)
    pl = dict(latents=[lat], inject=[inj], noise=[_noise_draws(k_n, B // 2)],
              probe=[_t(jax.random.normal(k_pl, (B // 2, 2, 3, RES, RES)))])
    return dict(main), pl


def _moments_by_name(opt_state, kind, noises):
    mu = jax.tree.map(np.asarray, extract_adam_moments(opt_state)["mu"])
    if kind == "d":
        return discriminator_state_from_jax(mu, DCFG)
    return generator_state_from_jax(mu, noises, GCFG)


# --------------------------------------------------- the port, per process


def _full_state(jnp_state):
    return train_state_from_jax(jnp_state, GCFG, DCFG, TrainingConfig(**CFG_KW))


def _sharded_state(saved):
    """A state built as the Trainer builds it (the models split over the
    model axis, then the optimizers and the EMA made from them), with
    ``saved`` (a one-process :func:`train_state_dict`) loaded into it."""
    g, d = Generator(GCFG), Discriminator(DCFG)
    g.load_state_dict(saved["generator"])
    d.load_state_dict(saved["discriminator"])
    tp.shard_model(g)
    tp.shard_model(d)
    state = port_create_train_state(g, d, TrainingConfig(**CFG_KW))
    load_train_state(state, saved)
    return state


def _step_fn():
    return TrainStep(TrainingConfig(**CFG_KW), top_k_start_iteration=0, top_k_final_iteration=4)


def _record_updates(state):
    """Every optimizer update's gradients, in order, gathered whole."""
    updates = []
    for opt in (state.d_opt, state.g_opt):
        def step(grads, _step=opt.step, _opt=opt):
            updates.append([None if g is None else tp.full_tensor(g.detach(), d).clone()
                            for g, d in zip(grads, _opt.shard_dims)])
            return _step(grads)
        opt.step = step
    return updates


def _moments(module, opt):
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: tp.full_tensor(m, d).clone()
            for p, m, d in zip(opt.params, opt.exp_avg, opt.shard_dims)}


def _run_step(state, ts, real, draws):
    """The main step, R1 and the Trainer's path-length update; the metrics,
    every update's gradients and the Adam moments after each stage."""
    updates = _record_updates(state)
    metrics = {k: float(v) for k, v in ts.main_step(state, real, StepFlags(**FLAGS),
                                                    draws).items()}
    moments = {"main_d": _moments(state.discriminator, state.d_opt),
               "main_g": _moments(state.generator, state.g_opt)}
    metrics["r1"] = float(ts.r1_update(state, real))
    moments["r1"] = _moments(state.discriminator, state.d_opt)
    pen, pl, _ = RobustPathLength(ts)(state, draws)
    metrics.update(pl_penalty=float(pen), path_length=float(pl),
                   mean_path_length=float(state.mean_path_length))
    moments["pl"] = _moments(state.generator, state.g_opt)
    return metrics, updates, moments


def _flat(tree):
    return list(mesh.tensors_of(tree))


def _sharded_bytes(state):
    """Bytes this rank holds of the sharded parameters, their Adam moments
    and their EMA mirrors."""
    n = 0
    for module, opt in ((state.generator, state.g_opt), (state.discriminator, state.d_opt)):
        for p, d, m, v in zip(opt.params, opt.shard_dims, opt.exp_avg, opt.exp_avg_sq):
            if d is not None:
                n += sum(t.numel() * t.element_size() for t in (p, m, v))
    ema = state.g_ema.state_dict()
    n += sum(ema[k].numel() * ema[k].element_size() for k in tp.sharded_keys(state.g_ema))
    return n


def _plan_bytes(state, n_model):
    """One process's bytes of what a model axis of ``n_model`` shards: the
    parameters, both their moments and their EMA mirrors."""
    total = 0
    for module, copies in ((state.generator, 3), (state.discriminator, 3), (state.g_ema, 1)):
        sd = module.state_dict()
        total += copies * sum(sd[k].numel() * sd[k].element_size()
                              for k in tp.shard_plan(module, n_model))
    return total


def _replicated(state):
    """Every replicated tensor of the state, in a fixed order."""
    local = train_state_dict(state)
    out = []
    for key, module in (("generator", state.generator), ("g_ema", state.g_ema),
                        ("discriminator", state.discriminator)):
        keys = tp.sharded_keys(module)
        out += [v.clone() for k, v in local[key].items() if k not in keys]
    for opt in (state.g_opt, state.d_opt):
        out += [m.clone() for m, d in zip(opt.exp_avg + opt.exp_avg_sq, opt.shard_dims * 2)
                if d is None]
    return out


def _stack_inputs():
    rng = np.random.default_rng(7)
    return dict(x=rng.normal(size=(4, 3, 8, 8)).astype(np.float32),
                w0=rng.normal(size=(8, 3, 3, 3)).astype(np.float32),
                w1=rng.normal(size=(4, 8, 3, 3)).astype(np.float32),
                b=rng.normal(size=(8,)).astype(np.float32),
                probe=rng.normal(size=(4, 4, 8, 8)).astype(np.float32))


def _stack(inp, shard):
    """conv (3 -> 8) + fused leaky ReLU + conv (8 -> 4): its output, the
    input gradient of <output, probe> and, of the squared input gradient
    (R1's form), the parameter gradients, whole."""
    convs = [EqualizedConv2d(3, 8, 3, 1, 1, bias=False), EqualizedConv2d(8, 4, 3, 1, 1)]
    act = FusedLeakyReLU(8)
    with torch.no_grad():
        convs[0].weight.copy_(torch.from_numpy(inp["w0"]))
        convs[1].weight.copy_(torch.from_numpy(inp["w1"]))
        act.bias.copy_(torch.from_numpy(inp["b"]))
    model = torch.nn.Sequential(convs[0], act, convs[1])
    if shard:
        tp.shard_model(model)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = model(x)
    params = list(model.parameters())  # w0, the activation's bias, w1, b1
    dims = tp.shard_dims(model, params)
    gx, *grads = torch.autograd.grad((y * torch.from_numpy(inp["probe"])).sum(), [x] + params,
                                     create_graph=True)
    # the biases move the input gradient nowhere (the leaky ReLU's mask is
    # piecewise constant): its square differentiates in the weights
    second = torch.autograd.grad(gx.square().sum(), [params[0], params[2]])
    return ([y.detach(), gx.detach()]
            + [tp.full_tensor(g.detach(), d) for g, d in zip(grads, dims)]
            + [tp.full_tensor(g, d) for g, d in zip(second, (dims[0], dims[2]))])


def _fft_bf16_d_grads(real):
    """The fft discriminator in bf16: its parameters' gradients (whole) of
    both heads' sum on ``real``, in f32."""
    d = Discriminator(tiny_discriminator_config(**D_KW, fft=True, compute_dtype="bfloat16"))
    d.reset_parameters(torch.Generator().manual_seed(5))
    tp.shard_model(d)
    s, p = d(real)
    params = list(d.parameters())
    grads = torch.autograd.grad(s.sum() + p.sum(), params)
    return [tp.full_tensor(g, dim).float() for g, dim in zip(grads, tp.shard_dims(d, params))]


def _rank_work(work_dir, layout):
    """Everything on this rank; writes ``<layout>_rank<r>.pt``."""
    with open(os.path.join(work_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"model_rank": mesh.model_rank(), "data_rank": mesh.rank()}
    if layout == "d1m2":
        out["stack"] = _stack(inp["stack"], shard=True)
        out["fft_bf16"] = _fft_bf16_d_grads(torch.from_numpy(inp["real"][:2]))
    state = _sharded_state(train_state_dict(_full_state(inp["jstate"])))
    out["sharded_bytes"] = _sharded_bytes(state)
    real = mesh.shard(torch.from_numpy(inp["real"]))
    draws = ShardDraws(ScriptedDraws(**_merge(inp["main"], inp["pl"])))
    out["metrics"], out["updates"], out["moments"] = _run_step(state, _step_fn(), real, draws)
    assert draws.inner.exhausted()
    out["replicated"] = _replicated(state)
    out["local"] = [t.detach().clone() for t in _flat(train_state_dict(state))]
    full = train_state_dict(state, full=True)
    if mesh.process_index() == 0:
        torch.save(full, os.path.join(work_dir, f"{layout}_checkpoint.pt"))
    # a one-process checkpoint restores as this rank's blocks, and gathers back whole
    saved = torch.load(os.path.join(work_dir, "one_checkpoint.pt"), weights_only=True)
    restored = _sharded_state(saved)
    out["restored_local"] = train_state_dict(restored)
    out["restored_full"] = train_state_dict(restored, full=True)
    torch.save(out, os.path.join(work_dir, f"{layout}_rank{mesh.process_index()}.pt"))


def _one_checkpoint(jstate):
    """A one-process state from JAX with Adam moments that tell their
    blocks apart, as a checkpoint."""
    state = _full_state(_np_state(jstate))
    gen = torch.Generator().manual_seed(11)
    for opt in (state.g_opt, state.d_opt):
        for m in opt.exp_avg + opt.exp_avg_sq:
            m.copy_(torch.rand(m.shape, generator=gen))
    return train_state_dict(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each layout's ranks' outputs, and this process's JAX and port results."""
    work = str(tmp_path_factory.mktemp("tp"))
    jstate, step_fn = _jax_setup()
    main_draws, pl_draws = _step_draws(jstate)
    real = np.random.default_rng(2).uniform(size=(B, 2, 3, RES, RES)).astype(np.float32)
    stack = _stack_inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(dict(jstate=_np_state(jstate), real=real, main=main_draws, pl=pl_draws,
                         stack=stack), f)
    torch.save(_one_checkpoint(jstate), os.path.join(work, "one_checkpoint.pt"))
    joins = [spawn("_rank_work", os.path.join(work, f"{name}_rendezvous"), *shape,
                   args=(work, name)) for name, shape in LAYOUTS.items()]
    failed = []
    try:
        jax_run, one = _this_process(jstate, step_fn, real, main_draws, pl_draws, stack)
    finally:
        for join in joins:  # every spawn's ranks end here, whatever failed
            try:
                join()
            except AssertionError as exc:
                failed.append(exc)
    if failed:
        raise failed[0]
    ranks = {name: [torch.load(os.path.join(work, f"{name}_rank{r}.pt"), weights_only=False)
                    for r in range(n_data * n_model)]
             for name, (n_data, n_model) in LAYOUTS.items()}
    return {"ranks": ranks, "jax": jax_run, "one": one, "work": work}


def _this_process(jstate, step_fn, real, main_draws, pl_draws, stack):
    """The JAX step and the port's one-process step, while the ranks run."""

    flags = JaxStepFlags(**{k: jnp.asarray(v) for k, v in FLAGS.items()})
    js1, jm = jax.jit(step_fn.main_step)(jstate, jnp.asarray(real), flags)
    js2, jpen = jax.jit(step_fn.r1_update)(js1, jnp.asarray(real))
    js3, jpen_pl, jpl = jax.jit(step_fn.path_length_update)(js2)
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    jax_run = {
        "metrics": {**{k: float(v) for k, v in jm.items()}, "r1": float(jpen),
                    "pl_penalty": float(jpen_pl), "path_length": float(jpl),
                    "mean_path_length": float(js3.mean_path_length)},
        "moments": {"main_d": _moments_by_name(js1.d_opt_state, "d", None),
                    "main_g": _moments_by_name(js1.g_opt_state, "g", noises),
                    "r1": _moments_by_name(js2.d_opt_state, "d", None),
                    "pl": _moments_by_name(js3.g_opt_state, "g", noises)}}
    state = _full_state(_np_state(jstate))
    plan_bytes = _plan_bytes(state, 2)
    draws = ScriptedDraws(**_merge(main_draws, pl_draws))
    one = dict(zip(("metrics", "updates", "moments"), _run_step(state, _step_fn(), _t(real),
                                                                draws)))
    assert draws.exhausted()
    one["stack"] = _stack(stack, shard=False)
    one["fft_bf16"] = _fft_bf16_d_grads(_t(real[:2]))
    one["sharded_bytes"] = plan_bytes
    return jax_run, one


# ------------------------------------------------------------------ checks


def _assert_close_to_peak(got, ref, tol, what):
    peak = max(float(np.abs(np.asarray(r, np.float32)).max()) for r in ref)
    assert peak > 0, what
    for i, (a, b) in enumerate(zip(got, ref)):
        a = np.asarray(a, np.float32)
        err = float(np.abs(a - np.asarray(b, np.float32).reshape(a.shape)).max())
        assert err <= tol * peak, (what, i, err, peak)


STACK_OUTPUTS = ("value", "input gradient", "w0 gradient", "bias gradient", "w1 gradient",
                 "b1 gradient", "w0 gradient of gradient", "w1 gradient of gradient")


def test_two_layer_stack_grad_and_grad_of_grad_match_one_process(runs):
    """Value, input gradient and the parameter gradients of the squared input
    gradient: the gather / slice and copy / reduce pairs crossed twice."""
    ref = runs["one"]["stack"]
    for r in runs["ranks"]["d1m2"]:
        assert len(r["stack"]) == len(ref) == len(STACK_OUTPUTS)
        for i, (a, b) in enumerate(zip(r["stack"], ref)):
            _assert_close_to_peak([a], [b], 1e-5, STACK_OUTPUTS[i])


def test_fft_discriminator_in_bf16_matches_one_process(runs):
    """The fft branch widens D's input and bf16 rounds every activation: the
    sharded D's gathered gradients within bf16's 2^-7 of the peak of one
    process's (the ranks' convs add their channels in other orders)."""
    ref = runs["one"]["fft_bf16"]
    for r in runs["ranks"]["d1m2"]:
        _assert_close_to_peak(r["fft_bf16"], ref, 2.0 ** -7, "fft bf16")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_gradients_match_one_process(runs, layout):
    """Each of the six updates (D step, cut-mix twice, G step, R1, path
    length): the gathered gradients against one process's, and the metrics."""
    one = runs["one"]["updates"]
    assert len(one) == 6
    for r in runs["ranks"][layout]:
        assert len(r["updates"]) == 6
        for k, (got, ref) in enumerate(zip(r["updates"], one)):
            assert all((a is None) == (b is None) for a, b in zip(got, ref))
            pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
            _assert_close_to_peak([a for a, _ in pairs], [b for _, b in pairs], 1e-5,
                                  f"{layout} update {k}")
        for k, v in runs["one"]["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("stage,tol", [("main_d", 1e-3), ("main_g", 1e-4), ("r1", 1e-3),
                                       ("pl", 1e-3)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_matches_jax(runs, layout, stage, tol):
    """The gathered Adam moments (with b1 = 0 the clipped gradient) after the
    main step, R1 and path length against the JAX single-device step on the
    global batch (which JAX's GSPMD step reproduces, tests/test_parallel.py)."""
    ref = runs["jax"]["moments"][stage]
    for r in runs["ranks"][layout]:
        got = r["moments"][stage]
        _assert_close_to_peak([got[n] for n in got], [ref[n].numpy() for n in got], tol,
                              (layout, stage))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_metrics_match_jax(runs, layout):
    for k, v in runs["jax"]["metrics"].items():
        for r in runs["ranks"][layout]:
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_replicated_leaves_are_bitwise_replicas(runs, layout):
    """After the iteration every replicated parameter, EMA mirror and moment
    is the same bits on every rank, and the ranks of a model column hold
    the same blocks (the data axis's replicas)."""
    ranks = runs["ranks"][layout]
    first = ranks[0]["replicated"]
    assert len(first) > 50
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, r["replicated"]))
        assert r["metrics"] == ranks[0]["metrics"]
    for a in ranks:
        for b in ranks:
            if a["model_rank"] == b["model_rank"]:
                assert all(torch.equal(x, y) for x, y in zip(a["local"], b["local"]))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_each_rank_holds_its_share_of_the_sharded_bytes(runs, layout):
    for r in runs["ranks"][layout]:
        assert r["sharded_bytes"] * 2 == runs["one"]["sharded_bytes"] > 0


def test_checkpoint_of_the_sharded_state_restores_bitwise_in_one_process(runs):
    """The (1, 2) run's checkpoint has the one-process layout; one process
    restores every tensor of it bit for bit."""
    saved = torch.load(os.path.join(runs["work"], "d1m2_checkpoint.pt"), weights_only=True)
    state = _full_state(_np_state(_jax_setup()[0]))
    load_train_state(state, saved)
    mine, theirs = _flat(train_state_dict(state)), _flat(saved)
    assert len(mine) == len(theirs) > 100
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(mine, theirs))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_process_checkpoint_restores_bitwise_under_tp(runs, layout):
    """A one-process checkpoint loads as each rank's blocks, and gathering
    them gives the file back bit for bit."""
    saved = torch.load(os.path.join(runs["work"], "one_checkpoint.pt"), weights_only=True)
    theirs = _flat(saved)
    for r in runs["ranks"][layout]:
        full = _flat(r["restored_full"])
        assert len(full) == len(theirs) > 100
        assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(full, theirs))
        local = _flat(r["restored_local"])
        assert sum(a.numel() for a in local) < sum(b.numel() for b in theirs)
