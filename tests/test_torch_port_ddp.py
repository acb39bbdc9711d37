"""Data parallelism of the PyTorch port (parallel/mesh.py) on the CPU: two
gloo ranks at the tiny configs against the JAX package on the global batch
and against one process of the port.

One spawn of two ranks (a module fixture; the rendezvous is a ``file://`` in
the test's own directory, since the suite's workers would collide on fixed
TCP ports) computes, and writes to files:

* (a) ``minibatch_std_dev``'s value, gradient and gradient of gradient,
  ``top_k_mask`` with a tie across the ranks, ``calc_r`` and the loss
  means, on each rank's rows of one global batch;
* (b) one main step at global batch 8 (wrong order, whose 2 rows both live
  on rank 0; cut-mix; top-k), R1 and the path-length update through the
  Trainer's ladder, from a JAX state carried across and the JAX key
  schedule's draws (each rank keeping its rows, train/draws.py::ShardDraws);
  then one more path-length update with an out-of-memory error injected on
  rank 1 only; and the Trainer's validation, whose metrics must see the
  global batches.

Meanwhile this process computes the JAX functions and step and the port's
one-process step on the same inputs.  Tolerances: (a) 1e-5 (f32, sums in
other orders); (b) gradients within 1e-4 of their peak against one process,
within the existing 1e-4 / 1e-3 of the peak against JAX
(tests/test_torch_port_train.py), metrics 1e-5 relative against one process
and 1e-4 against JAX (R1's and path length's, as there); the ranks bitwise
equal.
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
import torch.distributed as dist

from multi_stylegan_tpu.models import Discriminator as JaxDiscriminator
from multi_stylegan_tpu.models import Generator as JaxGenerator
from multi_stylegan_tpu.models.config import TrainingConfig as JaxTrainingConfig
from multi_stylegan_tpu.models.config import tiny_discriminator_config as jax_tiny_d
from multi_stylegan_tpu.models.config import tiny_generator_config as jax_tiny_g
from multi_stylegan_tpu.nn.normalization import minibatch_std_dev as jax_mbstd
from multi_stylegan_tpu.train import losses as jax_losses
from multi_stylegan_tpu.train.ada import calc_r as jax_calc_r
from multi_stylegan_tpu.train.noise import random_permutation as jax_random_permutation
from multi_stylegan_tpu.train.state import create_train_state
from multi_stylegan_tpu.train.steps import StepFlags as JaxStepFlags
from multi_stylegan_tpu.train.steps import make_train_step
from multi_stylegan_torch.data.pipeline import make_loader
from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset
from multi_stylegan_torch.io.checkpoint import train_state_dict
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.io.from_jax import train_state_from_jax
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.nn.normalization import minibatch_std_dev
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.train import losses
from multi_stylegan_torch.train.ada import calc_r
from multi_stylegan_torch.train.draws import ShardDraws, TorchDraws
from multi_stylegan_torch.train.loop import Trainer
from multi_stylegan_torch.train.robust import RobustPathLength
from multi_stylegan_torch.train.steps import StepFlags, TrainStep
from test_torch_port_train import (
    ScriptedDraws,
    _cut_draw,
    _fake_draws,
    _merge,
    _moments_by_name,
    _noise_draws,
    _np,
    _np_state,
    _t,
    _wplus_draws,
)

WORLD = 2
B = 8  # global: 4 rows a rank, wrong order 2 (both on rank 0), path length 4
CFG_KW = dict(batch_size=B, ada_p_init=0.0)
TIMEOUT_S = 170  # each spawn; a hung collective fails the test instead of the suite's clock
FLAGS = dict(wrong_order=True, trap_weight=False, do_cut_mix=True, do_ema=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- spawning


def _rank_entry(rank, world, init_method, fn_name, args):
    torch.set_num_threads(1)
    mesh.init(world, rank, init_method, torch.device("cpu"), timeout_s=TIMEOUT_S)
    try:
        globals()[fn_name](*args)
    finally:
        mesh.shutdown()


def spawn(fn_name, work_dir, args=(), world=WORLD):
    """Start ``world`` ranks running ``fn_name(*args)``; returns a join
    function that waits at most ``TIMEOUT_S`` from now and fails on a rank's
    non-zero exit or a hang (killing the ranks)."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{os.path.join(work_dir, 'rendezvous')}"
    procs = [ctx.Process(target=_rank_entry, args=(r, world, init, fn_name, args))
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
    """JAX models, a train state with every parameter perturbed and ADA at
    p = 0 (as test_torch_port_train.py's, at batch 8), and its step."""
    g, d = JaxGenerator(jax_tiny_g()), JaxDiscriminator(jax_tiny_d())
    cfg = JaxTrainingConfig(**CFG_KW)
    state = jax.jit(lambda key: create_train_state(key, g, d, cfg))(jax.random.key(1))
    rng = np.random.default_rng(1)

    def perturb(tree):
        return jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32)), tree)

    g_params = perturb(state.g_params)
    state = state.replace(g_params=g_params, g_ema_params=g_params,
                          d_params=perturb(state.d_params))
    return state, make_train_step(g, d, cfg, top_k_start_iteration=0, top_k_final_iteration=4)


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
    main = _merge(_fake_draws(k_fake, B), dict(perm=[perm], cut=[_cut_draw(k1), _cut_draw(k2)]),
                  _fake_draws(k_gf, B))
    k_w, k_n, k_pl = jax.random.split(jax.random.fold_in(base, 17), 3)
    lat, inj = _wplus_draws(k_w, B // 2)
    pl = dict(latents=[lat], inject=[inj], noise=[_noise_draws(k_n, B // 2)],
              probe=[_t(jax.random.normal(k_pl, (B // 2, 2, 3, 32, 32)))])
    return dict(main), pl


def _function_inputs():
    rng = np.random.default_rng(5)
    # rank 0's row 1 and rank 1's row 1 tie at the cut of k = 4 (rows 0, 3, 6 lead)
    pred = np.array([[0.9], [0.5], [0.1], [0.8], [-0.2], [0.5], [0.7], [-0.5]], np.float32)
    return dict(
        x=rng.normal(size=(B, 3, 4, 4)).astype(np.float32),
        w=rng.normal(size=(B, 4, 4, 4)).astype(np.float32),
        v=rng.normal(size=(B, 3, 4, 4)).astype(np.float32),
        pred=pred,
        s=rng.normal(size=(B, 1)).astype(np.float32),
        p=rng.normal(size=(B, 1, 3, 4, 4)).astype(np.float32),
        pr=rng.normal(size=(B, 1, 3, 4, 4)).astype(np.float32),
        pf=rng.normal(size=(B, 1, 3, 4, 4)).astype(np.float32),
        weight=rng.uniform(0.5, 2.0, size=(4, 4)).astype(np.float32),
        label=(rng.uniform(size=(B, 1, 3, 4, 4)) > 0.5).astype(np.float32),
    )


# --------------------------------------------------- the port, per process


def _port_state(jstate):
    state = train_state_from_jax(_np_state(jstate), tiny_generator_config(),
                                 tiny_discriminator_config(), TrainingConfig(**CFG_KW))
    return state, TrainStep(TrainingConfig(**CFG_KW), top_k_start_iteration=0,
                            top_k_final_iteration=4)


def _record_updates(state):
    """Every optimizer update's gradients, in order, as host copies."""
    updates = []
    for opt in (state.d_opt, state.g_opt):
        def step(grads, _step=opt.step):
            updates.append([None if g is None else g.detach().clone() for g in grads])
            return _step(grads)
        opt.step = step
    return updates


def _moments(module, opt):
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: m.clone() for p, m in zip(opt.params, opt.exp_avg)}


def _snapshot(state):
    return [t.detach().clone() for t in mesh.tensors_of(train_state_dict(state))]


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


def _rank_work(work_dir):
    """Both parts on this rank's rows; writes ``rank<r>.pt``."""
    with open(os.path.join(work_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    fn = {k: mesh.shard(torch.from_numpy(v)) for k, v in inp["functions"].items()
          if k != "weight"}
    out = {}
    x = fn["x"].clone().requires_grad_(True)
    y = minibatch_std_dev(x)
    (g,) = torch.autograd.grad((y * fn["w"]).sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad((g * fn["v"]).sum(), x)
    out["mbstd"] = [y.detach(), g.detach(), gg]
    out["top_k"] = losses.top_k_mask(fn["pred"], 0.5)
    out["calc_r"] = calc_r(fn["s"], fn["p"])
    weight = torch.from_numpy(inp["functions"]["weight"])
    out["loss_means"] = torch.stack([
        *losses.non_saturating_discriminator_loss(fn["pr"], fn["pf"], weight),
        *losses.non_saturating_discriminator_loss_cut_mix(fn["pr"], fn["label"])])

    state, ts = _port_state(inp["jstate"])
    real = mesh.shard(torch.from_numpy(inp["real"]))
    draws = ShardDraws(ScriptedDraws(**_merge(inp["main"], inp["pl"])))
    out["metrics"], updates, out["moments"] = _run_step(state, ts, real, draws)
    out["updates"] = list(updates)  # the ladder's update below records one more
    assert draws.inner.exhausted()
    out["state"] = _snapshot(state)

    ladder = RobustPathLength(ts, report=lambda msg: out.setdefault("reports", []).append(msg))
    if mesh.rank() == 1:
        sums = ts.path_length_sums

        def oom_once(state_, pld, n_chunks):
            ts.path_length_sums = sums
            raise torch.cuda.OutOfMemoryError("injected on rank 1")
        ts.path_length_sums = oom_once
    ladder(state, ShardDraws(ScriptedDraws(**inp["pl"])))
    out["oom"] = {"chunks": ladder.chunks, "state": _snapshot(state),
                  "step_moved": not all(torch.equal(a, b) for a, b in
                                        zip(out["state"], _snapshot(state)))}
    out["validation"] = _validation_batches(os.path.join(work_dir, f"exp{mesh.rank()}"))
    torch.save(out, os.path.join(work_dir, f"rank{mesh.rank()}.pt"))


def _validation_batches(experiment):
    """The real batches two validation metrics are given by the Trainer."""
    seen = []

    def probe(generator_apply, dataset):
        seen.append([b.clone() for b in dataset])
        return 0.0
    g, d = Generator(tiny_generator_config()), Discriminator(tiny_discriminator_config())
    loader = make_loader(SyntheticTLFMDataset(n_samples=20, resolution=(32, 32)), B, seed=4)
    trainer = Trainer(g, d, TrainingConfig(**CFG_KW), loader,
                      TorchDraws(torch.Generator().manual_seed(0)),
                      data_logger=Logger(experiment_path=experiment),
                      validation_metrics=(probe, probe))
    trainer.validation()
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' outputs, and this process's JAX and port results."""
    work = str(tmp_path_factory.mktemp("ddp"))
    jstate, step_fn = _jax_setup()
    main_draws, pl_draws = _step_draws(jstate)
    real = np.random.default_rng(2).uniform(size=(B, 2, 3, 32, 32)).astype(np.float32)
    functions = _function_inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(dict(jstate=_np_state(jstate), real=real, main=main_draws, pl=pl_draws,
                         functions=functions), f)
    join = spawn("_rank_work", work, (work,))

    # meanwhile: the JAX step and the port's one-process step
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
    state, ts = _port_state(jstate)
    draws = ScriptedDraws(**_merge(main_draws, pl_draws))
    one = dict(zip(("metrics", "updates", "moments"), _run_step(state, ts, _t(real), draws)))
    assert draws.exhausted()
    join()
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "jax": jax_run, "one": one, "functions": functions}


# -------------------------------------------------------------- (a) functions


def _global(runs, key, i=None):
    parts = [r[key] if i is None else r[key][i] for r in runs["ranks"]]
    return torch.cat(parts).numpy()


def test_minibatch_std_dev_value_grad_and_grad_of_grad_match_jax(runs):
    f = runs["functions"]
    x = jnp.asarray(f["x"].transpose(0, 2, 3, 1))  # JAX is NHWC
    w = jnp.asarray(f["w"].transpose(0, 2, 3, 1))
    v = jnp.asarray(f["v"].transpose(0, 2, 3, 1))

    def loss(x):
        return jnp.sum(jax_mbstd(x) * w)

    def grad_dot(x):
        return jnp.sum(jax.grad(loss)(x) * v)

    want = [jax_mbstd(x), jax.grad(loss)(x), jax.grad(grad_dot)(x)]
    for i, ref in enumerate(want):
        got = _global(runs, "mbstd", i)
        ref = np.asarray(ref).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=("value", "gradient", "gradient of gradient")[i])


def test_top_k_mask_breaks_ties_by_global_index(runs):
    f = runs["functions"]
    jmask, jk = jax_losses.top_k_mask(jnp.asarray(f["pred"]), jnp.asarray(0.5))
    np.testing.assert_array_equal(_global(runs, "top_k", 0), _np(jmask))
    assert [r["top_k"][1] for r in runs["ranks"]] == [float(jk)] * WORLD == [4.0] * WORLD
    assert _np(jmask)[1, 0] == 1 and _np(jmask)[5, 0] == 0  # the tie went to the lower index


def test_calc_r_and_loss_means_are_global(runs):
    f = {k: jnp.asarray(v) for k, v in runs["functions"].items()}
    want_r = float(jax_calc_r(f["s"], f["p"]))
    want_losses = [*jax_losses.non_saturating_discriminator_loss(f["pr"], f["pf"], f["weight"]),
                   *jax_losses.non_saturating_discriminator_loss_cut_mix(f["pr"], f["label"])]
    for r in runs["ranks"]:
        np.testing.assert_allclose(float(r["calc_r"]), want_r, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["loss_means"].numpy(), [float(a) for a in want_losses],
                                   rtol=1e-5)


# -------------------------------------------------------------- (b) the step


def _assert_close_to_peak(got, ref, tol, what):
    peak = max(float(np.abs(np.asarray(r, np.float32)).max()) for r in ref)
    assert peak > 0, what
    for i, (a, b) in enumerate(zip(got, ref)):
        a = np.asarray(a, np.float32)
        err = float(np.abs(a - np.asarray(b, np.float32).reshape(a.shape)).max())
        assert err <= tol * peak, (what, i, err, peak)


def test_step_gradients_match_one_process(runs):
    """Each of the six updates (D step, cut-mix twice, G step, R1, path
    length): the two ranks' summed gradients against one process's."""
    one = runs["one"]["updates"]
    assert len(one) == 6
    for r in runs["ranks"]:
        assert len(r["updates"]) == 6
        for k, (got, ref) in enumerate(zip(r["updates"], one)):
            pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
            assert all((a is None) == (b is None) for a, b in zip(got, ref))
            _assert_close_to_peak([a for a, _ in pairs], [b for _, b in pairs], 1e-4,
                                  f"update {k}")
    for k, v in runs["one"]["metrics"].items():
        for r in runs["ranks"]:
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("stage,tol", [("main_d", 1e-3), ("main_g", 1e-4), ("r1", 1e-3),
                                       ("pl", 1e-3)])
def test_step_matches_jax(runs, stage, tol):
    """The Adam moments (with b1 = 0 the clipped gradient) after the main
    step (D: the cut-mix consistency update; G: the G step), after R1 and
    after path length, against the JAX step on the global batch."""
    ref = runs["jax"]["moments"][stage]
    for r in runs["ranks"]:
        got = r["moments"][stage]
        _assert_close_to_peak([got[n] for n in got], [ref[n].numpy() for n in got], tol, stage)


def test_step_metrics_match_jax(runs):
    for k, v in runs["jax"]["metrics"].items():
        for r in runs["ranks"]:
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_ranks_are_bitwise_replicas(runs):
    a, b = runs["ranks"]
    assert len(a["state"]) == len(b["state"]) > 100
    assert all(torch.equal(x, y) for x, y in zip(a["state"], b["state"]))
    assert a["metrics"] == b["metrics"]


def test_out_of_memory_on_one_rank_demotes_both(runs):
    a, b = runs["ranks"]
    assert a["oom"]["chunks"] == b["oom"]["chunks"] == 2
    assert a["oom"]["step_moved"] and b["oom"]["step_moved"]
    assert all(torch.equal(x, y) for x, y in zip(a["oom"]["state"], b["oom"]["state"]))
    assert all("retrying in 2 chunks" in m for r in (a, b) for m in r["reports"])


def test_validation_sees_the_global_batches(runs):
    """Each metric's pass over the data gives it the global batches on every
    rank: one process's batches of the same seed, in its order."""
    loader = make_loader(SyntheticTLFMDataset(n_samples=20, resolution=(32, 32)), B, seed=4)
    want = [list(loader) for _ in range(2)]
    for r in runs["ranks"]:
        assert [len(p) for p in r["validation"]] == [2, 2]
        for got, ref in zip(r["validation"], want):
            assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ------------------------------------------------------ world size 1


def test_world_size_one_runs_no_collective(monkeypatch):
    """Without a process group the step runs no collective and every mesh
    helper is the plain expression it replaced, so the one-process step is
    today's, bit for bit."""
    def refuse(*a, **kw):
        raise AssertionError("a collective ran at world size 1")
    for name in ("all_reduce", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    assert mesh.world() == 1 and mesh.rank() == 0 and not dist.is_initialized()
    x = torch.randn(6, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(mesh.global_mean(x), x.mean())
    assert torch.equal(mesh.global_total(x), x.sum())
    assert mesh.gather_rows(x) is x and mesh.shard(x) is x and mesh.all_sum(x) is x
    assert torch.equal(mesh.head_rows(x, 2), x[:2])
    grads = [x, None]
    assert all(a is b for a, b in zip(mesh.all_reduce_grads(grads), grads))
    state, ts = _port_state(_jax_setup()[0])
    draws = TorchDraws(torch.Generator().manual_seed(0))
    real = torch.rand(B, 2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    m = ts.main_step(state, real, StepFlags(**FLAGS), draws)
    ts.r1_update(state, real)
    RobustPathLength(ts)(state, draws)
    assert all(np.isfinite(float(v)) for v in m.values())
