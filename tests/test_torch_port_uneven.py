"""Uneven data shards of the PyTorch port (parallel/mesh.py) on the CPU: the
wrong-order and path-length rows, their ADA draws and their minibatch
statistics split over data ranks they do not divide, some ranks holding no
row, against the JAX package's one-device step and the port's one process.

One spawn of four gloo ranks (a module fixture, the spawn helper and 170 s
limit of tests/test_torch_port_ddp.py) runs, and writes to files:

* (a) at the tiny config, global batch 12: 3 training rows a rank,
  wrong-order rows [1, 1, 1, 0], path-length rows [2, 2, 1, 1] (batch 24
  over 8 ranks at half the ranks).  One main step with wrong order,
  cut-mix and ADA at p = 0.5 (the JAX key schedule's draws, ADA's included),
  R1 and the path-length update through the Trainer's ladder; then two more
  ladder updates with an out-of-memory error injected on one rank: once on
  the rank with the smallest share, then at every tier on a 2-row rank;
* (b) global batch 4: 1 training row a rank, wrong order [1, 0, 0, 0], path
  length [1, 1, 0, 0], where G's modulated convs, noise, K1 and K3 run on
  zero rows;
* (c) the four ranks regrouped as a (data 2, model 2) mesh at the TP test's
  config, global batch 6: path length [2, 1], wrong order [1, 0].

Meanwhile this process runs the JAX step of (a) and the port's one process
at each layout.  Tolerances: every update's summed gradients within 1e-5 of
the one-process peak, metrics 1e-5 relative; against JAX the stage
tolerances of test_torch_port_ddp.py::test_step_matches_jax; the ranks
bitwise.  The zero-row plain paths of K1-K4 need no spawn (their launch
counts on the card: tests/test_torch_port_cuda.py).

Alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_uneven.py
-p no:randomly``.
"""

import functools
import math
import multiprocessing
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

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
from multi_stylegan_tpu.train.noise import random_permutation as jax_random_permutation
from multi_stylegan_tpu.train.state import create_train_state as jax_create_train_state
from multi_stylegan_tpu.train.steps import StepFlags as JaxStepFlags
from multi_stylegan_tpu.train.steps import make_train_step
from multi_stylegan_torch.io.checkpoint import load_train_state, train_state_dict
from multi_stylegan_torch.io.from_jax import train_state_from_jax
from multi_stylegan_torch.models.config import (
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.ops import fused_act
from multi_stylegan_torch.ops import upfirdn2d as up_mod
from multi_stylegan_torch.ops.blur import make_blur_kernel
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.parallel import tensor as tp
from multi_stylegan_torch.train.draws import ShardDraws, TorchDraws
from multi_stylegan_torch.train.robust import RobustPathLength, pl_chunk_tiers
from multi_stylegan_torch.train.state import create_train_state
from multi_stylegan_torch.train.steps import StepFlags, TrainStep
from test_torch_port_ada import jax_draws
from test_torch_port_tp import DCFG as TP_DCFG
from test_torch_port_tp import GCFG as TP_GCFG
from test_torch_port_train import (
    ScriptedDraws,
    _cut_draw,
    _fake_draws,
    _merge,
    _moments_by_name,
    _noise_draws,
    _np_state,
    _t,
    _wplus_draws,
)

WORLD = 4
B = 12  # (a): wrong order 3, path length 6
P = 0.5  # ADA's p: the warps run on the uneven rows
FLAGS = dict(wrong_order=True, trap_weight=False, do_cut_mix=True, do_ema=False)
B_EMPTY = 4  # (b)
B_TP = 6  # (c), over 2 data ranks
TIMEOUT_S = 170  # the spawn's; a hung collective fails the test instead of the suite's clock
TOL = 1e-5
# (a)'s ladder cases: the rank an out-of-memory error strikes, and how often
LADDER = {"smallest_share": (3, 1), "two_rows_every_tier": (0, 99)}


def _cfg(batch):
    return dict(batch_size=batch, ada_p_init=P)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- rows


@pytest.mark.parametrize("n,w", [(6, 4), (12, 8), (6, 8), (3, 4), (24, 4), (5, 1)])
def test_rows_and_counts_partition_the_batch(n, w, monkeypatch):
    """The blocks partition range(n) in rank order, differ by at most one
    row, and the larger ones come first (numpy.array_split's rule)."""
    monkeypatch.setattr(mesh, "world", lambda: w)
    counts = mesh.counts(n)
    assert counts == [len(a) for a in np.array_split(np.arange(n), w)]
    blocks = []
    for r in range(w):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        s = mesh.rows(n)
        assert s.stop - s.start == counts[r]
        blocks += list(range(n))[s]
    assert blocks == list(range(n))
    assert max(counts) - min(counts) <= 1 and counts == sorted(counts, reverse=True)


# ------------------------------------------------------------- spawning


def _rank_entry(rank, work_dir):
    torch.set_num_threads(1)
    for layout, n_model in (("dp", 1), ("tp", 2)):
        init = f"file://{os.path.join(work_dir, f'{layout}_rendezvous')}"
        mesh.init(WORLD, rank, init, torch.device("cpu"), timeout_s=TIMEOUT_S, n_model=n_model)
        try:
            globals()[f"_{layout}_work"](work_dir)
        finally:
            mesh.shutdown()


def spawn(work_dir):
    """Start the ranks; returns a join function that waits at most
    ``TIMEOUT_S`` from now and fails on a rank's non-zero exit or a hang
    (killing the ranks)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, work_dir)) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S

    def join():
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [p.pid for p in procs if p.is_alive()]
            assert not hung, f"ranks {hung} still running after {TIMEOUT_S} s"
            assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
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
    p = 0.5, and its step at batch 12."""
    g, d = JaxGenerator(jax_tiny_g()), JaxDiscriminator(jax_tiny_d())
    cfg = JaxTrainingConfig(**_cfg(B))
    state = jax.jit(lambda key: jax_create_train_state(key, g, d, cfg))(jax.random.key(2))
    rng = np.random.default_rng(2)

    def perturb(tree):
        return jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32)), tree)

    g_params = perturb(state.g_params)
    state = state.replace(g_params=g_params, g_ema_params=g_params,
                          d_params=perturb(state.d_params))
    return state, make_train_step(g, d, cfg, top_k_start_iteration=0, top_k_final_iteration=4)


class AdaScriptedDraws(ScriptedDraws):
    """:class:`ScriptedDraws` that also hands out prepared ADA draws."""

    def ada(self, batch, h, w, p):
        d = self._pop("ada")
        assert d.flip.shape[0] == batch, (d.flip.shape, batch)
        return d


def _step_draws(jstate):
    """The global draws of the JAX main step at step 1 (ADA's for the
    reals, fakes, wrong-order rows and the G step's fakes among them) and
    of the path-length update after it (JAX steps.py:153, 275, 426-431,
    508-509)."""
    base = jax.random.fold_in(jstate.rng, 1)
    k_d, k_cm, k_g, _ = jax.random.split(base, 4)
    k_fake, k_perm, k_ar, k_af, k_aw = jax.random.split(k_d, 5)
    perm = torch.from_numpy(np.asarray(jax_random_permutation(k_perm, 3)).astype(np.int64))
    k1, k2 = jax.random.split(k_cm)
    k_gf, k_aug = jax.random.split(k_g)
    n_wrong = TrainStep(TrainingConfig(**_cfg(B))).wrong_order_batch(B)
    ada = [jax_draws(k, n, 32, 32, P) for k, n in ((k_ar, B), (k_af, B), (k_aw, n_wrong),
                                                   (k_aug, B))]
    main = _merge(_fake_draws(k_fake, B), dict(perm=[perm], cut=[_cut_draw(k1), _cut_draw(k2)],
                                               ada=ada), _fake_draws(k_gf, B))
    k_w, k_n, k_pl = jax.random.split(jax.random.fold_in(base, 17), 3)
    lat, inj = _wplus_draws(k_w, B // 2)
    pl = dict(latents=[lat], inject=[inj], noise=[_noise_draws(k_n, B // 2)],
              probe=[_t(jax.random.normal(k_pl, (B // 2, 2, 3, 32, 32)))])
    return dict(main), pl


def _tp_state_dict():
    """A one-process state at the TP test's config: seeded weights with
    every parameter perturbed, as a :func:`train_state_dict`."""
    g, d = Generator(TP_GCFG), Discriminator(TP_DCFG)
    gen = torch.Generator().manual_seed(6)
    g.reset_parameters(gen)
    d.reset_parameters(gen)
    with torch.no_grad():
        for p in list(g.parameters()) + list(d.parameters()):
            p.add_(0.3 * torch.randn(p.shape, generator=gen))
    return train_state_dict(create_train_state(g, d, TrainingConfig(**_cfg(B_TP))))


# --------------------------------------------------- the port, per process


def _port_state(np_state, batch):
    state = train_state_from_jax(np_state, tiny_generator_config(),
                                 tiny_discriminator_config(), TrainingConfig(**_cfg(batch)))
    return state, TrainStep(TrainingConfig(**_cfg(batch)), top_k_start_iteration=0,
                            top_k_final_iteration=4)


def _tp_port_state(saved):
    """``saved`` in a state built as the Trainer builds it (the models split
    over the model axis, then the optimizers and the EMA made from them)."""
    g, d = Generator(TP_GCFG), Discriminator(TP_DCFG)
    g.load_state_dict(saved["generator"])
    d.load_state_dict(saved["discriminator"])
    tp.shard_model(g)
    tp.shard_model(d)
    state = create_train_state(g, d, TrainingConfig(**_cfg(B_TP)))
    load_train_state(state, saved)
    return state, TrainStep(TrainingConfig(**_cfg(B_TP)), top_k_start_iteration=0,
                            top_k_final_iteration=4)


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


def _snapshot(state):
    return [t.detach().clone() for t in mesh.tensors_of(train_state_dict(state, full=True))]


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


def _ladder_case(state, ts, victim, times, seed):
    """One ladder update from this state with ``times`` out-of-memory errors
    injected into the path-length sums on rank ``victim``: its tier, whether
    it skipped, the state after it and whether the state moved."""
    before = _snapshot(state)
    ladder = RobustPathLength(ts, report=lambda msg: None)
    left = [times if mesh.rank() == victim else 0]
    sums = ts.path_length_sums

    def maybe_oom(*a):
        if left[0]:
            left[0] -= 1
            raise torch.cuda.OutOfMemoryError(f"injected on rank {victim}")
        return sums(*a)
    ts.path_length_sums = maybe_oom
    try:
        _, _, metrics = ladder(state, ShardDraws(TorchDraws(torch.Generator().manual_seed(seed))))
    finally:
        ts.path_length_sums = sums
    after = _snapshot(state)
    return {"tiers": ladder.tiers, "chunks": ladder.chunks,
            "skipped": float(metrics["path_length_skipped"]), "state": after,
            "moved": not all(torch.equal(a, b) for a, b in zip(before, after))}


def _rows_of(batch, ts):
    return {"train": mesh.rows(batch), "wrong": mesh.rows(ts.wrong_order_batch(batch)),
            "path_length": mesh.rows(ts.path_length_batch(batch))}


def _dp_work(work_dir):
    """(a) and (b) on this rank; writes ``dp_rank<r>.pt``."""
    with open(os.path.join(work_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    probe = inp["pl"]["probe"][0]
    out = {"gathered": mesh.gather_rows(mesh.shard(probe), probe.shape[0])}
    state, ts = _port_state(inp["jstate"], B)
    out["rows"] = _rows_of(B, ts)
    draws = ShardDraws(AdaScriptedDraws(**_merge(inp["main"], inp["pl"])))
    real = mesh.shard(torch.from_numpy(inp["real"]))
    out["metrics"], updates, out["moments"] = _run_step(state, ts, real, draws)
    out["updates"] = list(updates)  # the ladder's updates below record more
    assert draws.inner.exhausted()
    out["state"] = _snapshot(state)
    out["ladder"] = {case: _ladder_case(state, ts, victim, times, seed=20 + i)
                     for i, (case, (victim, times)) in enumerate(LADDER.items())}

    state, ts = _port_state(inp["jstate"], B_EMPTY)
    out["empty_rows"] = _rows_of(B_EMPTY, ts)
    real = mesh.shard(torch.from_numpy(inp["real"][:B_EMPTY]))
    draws = ShardDraws(TorchDraws(torch.Generator().manual_seed(4)))
    out["empty_metrics"], out["empty_updates"], _ = _run_step(state, ts, real, draws)
    out["empty_state"] = _snapshot(state)
    torch.save(out, os.path.join(work_dir, f"dp_rank{mesh.process_index()}.pt"))


def _tp_work(work_dir):
    """(c) on this rank; writes ``tp_rank<r>.pt``."""
    state, ts = _tp_port_state(torch.load(os.path.join(work_dir, "tp_state.pt")))
    real = torch.load(os.path.join(work_dir, "tp_real.pt"))
    out = {"rows": _rows_of(B_TP, ts), "model_rank": mesh.model_rank()}
    draws = ShardDraws(TorchDraws(torch.Generator().manual_seed(7)))
    out["metrics"], out["updates"], _ = _run_step(state, ts, mesh.shard(real), draws)
    out["state"] = _snapshot(state)
    torch.save(out, os.path.join(work_dir, f"tp_rank{mesh.process_index()}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs, and this process's JAX and port results."""
    work = str(tmp_path_factory.mktemp("uneven"))
    jstate, step_fn = _jax_setup()
    real = np.random.default_rng(3).uniform(size=(B, 2, 3, 32, 32)).astype(np.float32)
    flags = JaxStepFlags(**{k: jnp.asarray(v) for k, v in FLAGS.items()})
    # the three JAX programs compile at once (their inputs share jstate's
    # structure), and meanwhile the draws are made and the ranks run
    args = {"main_step": (jstate, jnp.asarray(real), flags),
            "r1_update": (jstate, jnp.asarray(real)), "path_length_update": (jstate,)}
    with ThreadPoolExecutor(len(args)) as pool:
        compiling = {name: pool.submit(lambda n=name, a=a: jax.jit(getattr(step_fn, n))
                                       .lower(*a).compile()) for name, a in args.items()}
        main_draws, pl_draws = _step_draws(jstate)
        np_state = _np_state(jstate)
        with open(os.path.join(work, "inputs.pkl"), "wb") as f:
            pickle.dump(dict(jstate=np_state, real=real, main=main_draws, pl=pl_draws), f)
        tp_saved = _tp_state_dict()
        res = TP_GCFG.resolution[0]
        tp_real = torch.from_numpy(np.random.default_rng(8).uniform(
            size=(B_TP, 2, 3, res, res)).astype(np.float32))
        torch.save(tp_saved, os.path.join(work, "tp_state.pt"))
        torch.save(tp_real, os.path.join(work, "tp_real.pt"))
        join = spawn(work)
        try:
            # meanwhile: the port's one process at each layout, then JAX's step
            state, ts = _port_state(np_state, B)
            draws = AdaScriptedDraws(**_merge(main_draws, pl_draws))
            one = dict(zip(("metrics", "updates", "moments"),
                           _run_step(state, ts, _t(real), draws)))
            assert draws.exhausted()
            state, ts = _port_state(np_state, B_EMPTY)
            one["empty_metrics"], one["empty_updates"], _ = _run_step(
                state, ts, _t(real[:B_EMPTY]), TorchDraws(torch.Generator().manual_seed(4)))
            state, ts = _tp_port_state(tp_saved)
            one["tp_metrics"], one["tp_updates"], _ = _run_step(
                state, ts, tp_real, TorchDraws(torch.Generator().manual_seed(7)))
            jit = {name: c.result() for name, c in compiling.items()}
            js1, jm = jit["main_step"](*args["main_step"])
            js2, jpen = jit["r1_update"](js1, jnp.asarray(real))
            js3, jpen_pl, jpl = jit["path_length_update"](js2)
        finally:
            join()
    noises = jax.tree.map(np.asarray, jstate.g_noises)
    jax_run = {
        "metrics": {**{k: float(v) for k, v in jm.items()}, "r1": float(jpen),
                    "pl_penalty": float(jpen_pl), "path_length": float(jpl),
                    "mean_path_length": float(js3.mean_path_length)},
        "moments": {"main_d": _moments_by_name(js1.d_opt_state, "d", None),
                    "main_g": _moments_by_name(js1.g_opt_state, "g", noises),
                    "r1": _moments_by_name(js2.d_opt_state, "d", None),
                    "pl": _moments_by_name(js3.g_opt_state, "g", noises)}}
    ranks = {layout: [torch.load(os.path.join(work, f"{layout}_rank{r}.pt"), weights_only=False)
                      for r in range(WORLD)] for layout in ("dp", "tp")}
    return {"ranks": ranks, "jax": jax_run, "one": one, "probe": pl_draws["probe"][0]}


# -------------------------------------------------------------- checks


def _assert_close_to_peak(got, ref, tol, what):
    peak = max(float(np.abs(np.asarray(r, np.float32)).max()) for r in ref)
    assert peak > 0, what
    for i, (a, b) in enumerate(zip(got, ref)):
        a = np.asarray(a, np.float32)
        err = float(np.abs(a - np.asarray(b, np.float32).reshape(a.shape)).max())
        assert err <= tol * peak, (what, i, err, peak)


def _assert_updates_match(ranks, key, ref):
    """Each update (D step, cut-mix twice, G step, R1, path length): every
    rank's summed gradients against one process's."""
    assert len(ref) == 6
    for r, rank in enumerate(ranks):
        assert len(rank[key]) == 6
        for k, (got, want) in enumerate(zip(rank[key], ref)):
            assert [g is None for g in got] == [g is None for g in want], (r, k)
            pairs = [(a, b) for a, b in zip(got, want) if b is not None]
            _assert_close_to_peak([a for a, _ in pairs], [b for _, b in pairs], TOL,
                                  f"rank {r} update {k}")


def _assert_metrics_match(ranks, key, ref):
    for k, v in ref.items():
        for rank in ranks:
            np.testing.assert_allclose(rank[key][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def _assert_bitwise(ranks, key):
    first = ranks[0][key]
    assert len(first) > 100
    for rank in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, rank[key]))


def test_the_layout_is_uneven(runs):
    """Batch 24 over 8 ranks at half the ranks, and (b) and (c)'s layouts."""
    def sizes(ranks, rows_key, kind):
        return [r[rows_key][kind].stop - r[rows_key][kind].start for r in ranks]
    dp, tp_ranks = runs["ranks"]["dp"], runs["ranks"]["tp"]
    assert sizes(dp, "rows", "train") == [3, 3, 3, 3]
    assert sizes(dp, "rows", "wrong") == [1, 1, 1, 0]
    assert sizes(dp, "rows", "path_length") == [2, 2, 1, 1]
    assert sizes(dp, "empty_rows", "wrong") == [1, 0, 0, 0]
    assert sizes(dp, "empty_rows", "path_length") == [1, 1, 0, 0]
    assert [r["model_rank"] for r in tp_ranks] == [0, 1, 0, 1]
    assert sizes(tp_ranks, "rows", "wrong") == [1, 1, 0, 0]
    assert sizes(tp_ranks, "rows", "path_length") == [2, 2, 1, 1]


def test_gather_rows_rebuilds_an_uneven_batch(runs):
    """The path-length probe's 6 rows, held as [2, 2, 1, 1], gathered whole
    on every rank."""
    for r in runs["ranks"]["dp"]:
        assert torch.equal(r["gathered"], runs["probe"])


def test_step_gradients_match_one_process(runs):
    _assert_updates_match(runs["ranks"]["dp"], "updates", runs["one"]["updates"])
    _assert_metrics_match(runs["ranks"]["dp"], "metrics", runs["one"]["metrics"])


@pytest.mark.parametrize("stage,tol", [("main_d", 1e-3), ("main_g", 1e-4), ("r1", 1e-3),
                                       ("pl", 1e-3)])
def test_step_matches_jax(runs, stage, tol):
    """The Adam moments (with b1 = 0 the clipped gradient) after the main
    step, R1 and path length, against the JAX step on the global batch."""
    ref = runs["jax"]["moments"][stage]
    for r in runs["ranks"]["dp"]:
        got = r["moments"][stage]
        _assert_close_to_peak([got[n] for n in got], [ref[n].numpy() for n in got], tol, stage)


def test_step_metrics_match_jax(runs):
    for k, v in runs["jax"]["metrics"].items():
        for r in runs["ranks"]["dp"]:
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_ranks_are_bitwise_replicas(runs):
    """Every rank, the one without wrong-order rows included."""
    ranks = runs["ranks"]["dp"]
    _assert_bitwise(ranks, "state")
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


def test_empty_path_length_ranks_match_one_process(runs):
    """(b): ranks 2 and 3 hold no path-length row and rank 1-3 no
    wrong-order row."""
    ranks = runs["ranks"]["dp"]
    _assert_updates_match(ranks, "empty_updates", runs["one"]["empty_updates"])
    _assert_metrics_match(ranks, "empty_metrics", runs["one"]["empty_metrics"])
    _assert_bitwise(ranks, "empty_state")


@pytest.mark.parametrize("case", sorted(LADDER))
def test_out_of_memory_on_one_rank_moves_every_rank_alike(runs, case):
    """Once on the 1-row rank: every rank demotes to 2 chunks (the 1-row
    ranks then run an empty chunk) and updates; at every tier on a 2-row
    rank: every rank skips the update and keeps its state."""
    outs = [r["ladder"][case] for r in runs["ranks"]["dp"]]
    want = {"smallest_share": (2, 0.0, True), "two_rows_every_tier": (0, 1.0, False)}[case]
    for o in outs:
        assert (o["chunks"], o["skipped"], o["moved"]) == want
    _assert_bitwise(outs, "state")


def test_every_rank_walks_the_global_ladder(runs):
    for r in runs["ranks"]["dp"]:
        for o in r["ladder"].values():
            assert o["tiers"] == (1,) + pl_chunk_tiers(6) == (1, 2, 3, 6)


def test_data2_model2_uneven_matches_one_process(runs):
    """(c): each data rank's two model ranks hold its rows; data rank 1
    has no wrong-order row."""
    ranks = runs["ranks"]["tp"]
    _assert_updates_match(ranks, "updates", runs["one"]["tp_updates"])
    _assert_metrics_match(ranks, "metrics", runs["one"]["tp_metrics"])
    _assert_bitwise(ranks, "state")


# ------------------------------------------------- zero rows in the ops


def _double_backward(op, x, params=()):
    """``op`` on ``x``, its gradients w.r.t. ``x`` and ``params`` through a
    probe ``v``, and the gradient of their squares w.r.t. ``v`` (the
    double backward R1 and path length run)."""
    x = x.clone().requires_grad_(True)
    y = op(x)
    v = torch.randn(y.shape).requires_grad_(True)
    grads = torch.autograd.grad((y * v).sum(), [x, *params], create_graph=True)
    (second,) = torch.autograd.grad(sum(g.square().sum() for g in grads), v)
    return y, grads, second


def _k2_plain(g, out, need_db):
    return fused_act.fused_leaky_relu_grad_ref(g, out, 0.2, math.sqrt(2.0),
                                               torch.randn(g.shape[-1]), need_db)


@pytest.mark.parametrize("form", ["k1_k2", "k2_bias_sum", "k2_dx_only", "k3_up1_down1",
                                  "k3_up2_down1", "k3_up1_down2", "k4"])
def test_zero_rows_in_the_plain_path(form):
    """A data rank's empty share through each op's plain path (what a CPU
    tensor takes): an empty result of the right shape and dtype; grad and
    grad of grad run, the bias gradients exact zeros."""
    x = torch.randn(0, 4, 4, 8)
    taps = make_blur_kernel((1, 3, 3, 1), 1.0)
    if form == "k1_k2":
        bias = torch.randn(8, requires_grad=True)
        y, grads, second = _double_backward(
            lambda t: fused_act.fused_leaky_relu(t, bias), x, [bias])
        assert y.shape == x.shape and y.dtype == x.dtype
        assert grads[0].shape == x.shape and torch.equal(grads[1], torch.zeros(8))
        assert second.shape == x.shape  # the dx-only K2 with the bias sum's addend
        return
    if form.startswith("k2"):
        dx, db = _k2_plain(x, x, form == "k2_bias_sum")
        assert dx.shape == x.shape and dx.dtype == x.dtype
        assert db is None if form == "k2_dx_only" else torch.equal(db, torch.zeros(8))
        return
    up, down, pad = {"k3_up1_down1": (1, 1, (2, 1)), "k3_up2_down1": (2, 1, (2, 1)),
                     "k3_up1_down2": (1, 2, (1, 1)), "k4": (2, 1, (2, 1))}[form]
    y, grads, second = _double_backward(lambda t: up_mod.upfirdn2d(t, taps, up, down, pad), x)
    ho = up_mod.out_size(4, up, down, pad[0], pad[1], 4)
    assert y.shape == (0, ho, ho, 8) and y.dtype == x.dtype
    assert grads[0].shape == x.shape  # K4, the adjoint
    assert second.shape == y.shape  # the adjoint's own backward, K3 again
