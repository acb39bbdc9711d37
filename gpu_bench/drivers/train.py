"""Driver of the training cells: a closed loop of whole lazy cycles over
device-resident real batches, through the port's own iteration
(``Trainer._run_step``: ``TrainStep.main_step``, then ``r1_update`` and the
path-length ladder on every 16th step), each step's metrics read to the host
as ``Trainer.train`` reads them.

Set-up builds one Trainer from weights made from the seed and drives it
through its first steps (``check_steps``, the last of them a regularised
one) on distinct batches; those steps record what ``correct`` compares
(each step's losses, each optimizer's first gradient from its state, each
leaf's change over the steps), with every draw kept for the reference.
The same Trainer then runs the window: the cycles nearest to ``--seconds``
at the cycle time the set-up steps give, at least one.  After the window
the reference works the first steps out again from the same weights,
batches and draws (``compare``).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from gpu_bench import check, flops, kernels
from gpu_bench.reference.draws import Replay, SeededDraws
from gpu_bench.reference.inputs import real_batches, trap_weights_map
from gpu_bench.reference.weights import make_weights


def seeds(seed: int) -> Dict[str, int]:
    """Independent sub-seeds of a run's seed."""
    w, d, r = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)
    return {"weights": int(w), "data": int(d), "draws": int(r)}


class FirstGradient:
    """Records each leaf's norm of an optimizer's first gradient, worked out
    from its state after its first update (Adam's first moment over
    1 - beta1), by wrapping its ``step`` until :meth:`remove`."""

    def __init__(self, opt):
        self.opt, self.norms = opt, None
        self._step = opt.step
        opt.step = self

    def __call__(self, grads):
        applied = self._step(grads)
        if self.norms is None:
            self.norms = torch.stack([m.float().norm() for m in self.opt.exp_avg]) / (
                1.0 - self.opt.b1)
        return applied

    def remove(self) -> List[float]:
        del self.opt.step
        return self.norms.tolist()


def leaf_norms(tensors) -> List[float]:
    return torch.stack([t.float().norm() for t in tensors]).tolist()


class Recorder:
    """What the first steps of either side give for the comparison."""

    def __init__(self, state):
        self.state = state
        self.start = [p.detach().clone() for p in self._leaves()]
        self.first = (FirstGradient(state.g_opt), FirstGradient(state.d_opt))
        self.losses: List[Dict[str, float]] = []

    def _leaves(self):
        s = self.state
        return [*s.generator.parameters(), *s.discriminator.parameters(),
                *s.g_ema.parameters()]

    def finish(self) -> dict:
        change = leaf_norms([p.detach() - p0 for p, p0 in zip(self._leaves(), self.start)])
        g_first, d_first = (f.remove() for f in self.first)
        self.start = None
        return {"losses": self.losses, "first_grad": g_first + d_first, "change": change}


def candidates(program: dict, reference: dict, n_g: int) -> Dict[str, float]:
    """Every number a limit could be set on, for the calibration's look:
    the loss gaps (all steps, the first), the first-gradient gaps and the
    change gaps by worst and median leaf, of all leaves and of G, D and the
    EMA apart."""
    keep = check.quiet(reference["first_grad"])
    n = len(keep)  # G's leaves, then D's; the change adds the EMA's (G's again)
    parts = {"g": slice(0, n_g), "d": slice(n_g, n), "ema": slice(n, None)}
    out = {"loss_gap": check.loss_gap(program["losses"], reference["losses"]),
           "loss_gap_first": check.loss_gap(program["losses"][:1], reference["losses"][:1])}
    for name, p, r, k in (("first_grad", program["first_grad"], reference["first_grad"], keep),
                          ("change", program["change"], reference["change"],
                           keep + keep[:n_g])):
        gaps = check.leaf_gaps(p, r, k)
        out.update({f"{name}_gap": max(gaps), f"{name}_median": statistics.median(gaps)})
        for part, rows in parts.items():
            if rows.start < len(p):
                g = check.leaf_gaps(p[rows], r[rows], k[rows])
                out.update({f"{name}_gap_{part}": max(g),
                            f"{name}_median_{part}": statistics.median(g)})
    return out


# The numbers ``correct`` holds against their limits (PERF.md gives the
# readings each limit was set from and the look behind the choice): the
# widest gap of a step's loss; D's first gradient by its worst leaf; the
# change over the steps of D, G and the EMA, each by its median leaf.  G's
# first gradient and every worst leaf of the change are not compared: with
# beta1 0 each Adam step moves an element by about lr whatever its
# gradient, so rounding-level gradients become lr-sized differences that
# the later sub-steps carry, and the G step's top-k choice is discrete.
COMPARED = ("loss_gap", "first_grad_gap_d", "change_median_d", "change_median_g",
            "change_median_ema")


def compare(program: dict, reference: dict, n_g: int) -> Dict[str, float]:
    got = candidates(program, reference, n_g)
    return {k: got[k] for k in COMPARED}


# ------------------------------------------------------------------ program


class Program:
    """The port's Trainer at a cell's configuration, its inputs made from
    the seed."""

    def __init__(self, ctx):
        from multi_stylegan_torch.io.logger import Logger
        from multi_stylegan_torch.models.discriminator import Discriminator
        from multi_stylegan_torch.models.generator import Generator
        from multi_stylegan_torch.train.loop import Trainer

        from multi_stylegan_torch.utils.precision import pin_f32

        from gpu_bench.bench import port_configs

        pin_f32()  # TF32 off, as the CLIs run
        t = ctx.traffic
        self.ctx, self.dev = ctx, ctx.device
        self.gcfg, dcfg, self.tcfg = port_configs(
            ctx.config, training={"batch_size": t["batch"], "seed": t["schedule_seed"]},
            **ctx.overrides)
        s = seeds(ctx.seed)
        gen, disc = Generator(self.gcfg, device=self.dev), Discriminator(dcfg, device=self.dev)
        make_weights([gen, disc], s["weights"])
        shape = (self.gcfg.num_domains, self.gcfg.sequence_length, *self.gcfg.resolution)
        self.batches = real_batches(t["real_batches"], t["batch"], shape, s["data"], self.dev)
        self.draws = SeededDraws(torch.Generator(device=self.dev).manual_seed(s["draws"]),
                                 record=True)
        run_dir = ctx.out / "run"
        self.trainer = Trainer(gen, disc, self.tcfg, loader=self.batches, draws=self.draws,
                               epochs=1, data_logger=Logger(experiment_path=str(run_dir)),
                               trap_weights_map=trap_weights_map(self.gcfg.resolution),
                               checkpoint_dir=str(run_dir / "models"))
        self.flags = self.trainer._epoch_flags(0)
        self.trainer.state.step = t["first_step"]
        if (t["first_step"] + t["check_steps"]) % self.tcfg.lazy_generator_regularization:
            raise ValueError("the set-up steps must end on a regularised step")
        self.n = 0
        self.cut_mix: List[bool] = []  # whether each iteration ran the cut-mix step

    def iterate(self) -> Dict[str, float]:
        """One iteration of the Trainer's loop on the next real batch; its
        metrics read to the host."""
        from multi_stylegan_torch.train.loop import schedule_coin
        from multi_stylegan_torch.train.steps import StepFlags

        tr, cfg = self.trainer, self.tcfg
        wrong_order, trap, cm_prob = self.flags
        step = tr.state.step + 1
        flags = StepFlags(wrong_order=wrong_order, trap_weight=trap,
                          do_cut_mix=schedule_coin(cfg.seed, step) <= cm_prob,
                          do_ema=step % cfg.lazy_generator_regularization != 0)
        real = self.batches[self.n % len(self.batches)]
        self.n += 1
        self.cut_mix.append(flags.do_cut_mix)
        metrics = tr._run_step(real, flags, step % cfg.lazy_discriminator_regularization == 0,
                               step % cfg.lazy_generator_regularization == 0)
        return {k: float(v) for k, v in metrics.items()}  # waits for the device

    def first_steps(self) -> tuple:
        """The set-up steps: their record and their wall seconds."""
        rec = Recorder(self.trainer.state)
        walls = []
        for _ in range(self.ctx.traffic["check_steps"]):
            t0 = time.perf_counter()
            rec.losses.append(self.iterate())
            walls.append(time.perf_counter() - t0)
        self.draws.records, records = None, self.draws.records
        return rec.finish(), records, walls

    def free(self) -> None:
        self.trainer = self.batches = self.draws = None


# ---------------------------------------------------------------- reference


def reference_chunks(rows: int) -> int:
    """The reference's path-length chunks: the most of 1, 2, 3, 4, 6 that
    leave 3 rows or more each (the same draws; it bounds the memory)."""
    return max((c for c in (1, 2, 3, 4, 6) if rows % c == 0 and rows // c >= 3), default=1)


def reference_steps(ctx, records, n_steps: int) -> dict:
    """The reference's first steps from the same weights, batches and draws."""
    from gpu_bench.bench import reference_configs
    from gpu_bench.reference import loop
    from gpu_bench.reference.discriminator import Discriminator
    from gpu_bench.reference.generator import Generator
    from gpu_bench.reference.state import create_train_state
    from gpu_bench.reference.steps import TrainStep

    t, dev = ctx.traffic, ctx.device
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gcfg, dcfg, tcfg = reference_configs(
        ctx.config, training={"batch_size": t["batch"], "seed": t["schedule_seed"]},
        **ctx.overrides)
    s = seeds(ctx.seed)
    gen, disc = Generator(gcfg, device=dev), Discriminator(dcfg, device=dev)
    make_weights([gen, disc], s["weights"])
    shape = (gcfg.num_domains, gcfg.sequence_length, *gcfg.resolution)
    batches = real_batches(t["real_batches"], t["batch"], shape, s["data"], dev)[:n_steps]
    state = create_train_state(gen, disc, tcfg)
    start, final = loop.top_k_iterations(tcfg, len(batches))
    step_fn = TrainStep(tcfg, top_k_start_iteration=start, top_k_final_iteration=final,
                        trap_weights_map=torch.as_tensor(trap_weights_map(gcfg.resolution)))
    draws = Replay(records, dev)
    wrong_order, trap, cm_prob = loop.epoch_flags(tcfg, 0, 1)
    state.step = t["first_step"]
    pl_chunks = reference_chunks(step_fn.path_length_batch(tcfg.batch_size))
    rec = Recorder(state)
    for real in batches:
        flags, lazy_d, lazy_g = loop.step_flags(tcfg, state.step + 1, wrong_order, trap,
                                                cm_prob)
        metrics = loop.run_step(step_fn, state, real, flags, lazy_d, lazy_g, draws, pl_chunks)
        rec.losses.append({k: float(v) for k, v in metrics.items()})
    out = rec.finish()
    out["n_g"] = len(list(gen.parameters()))
    return out


# ----------------------------------------------------------------- the run


def run(ctx) -> dict:
    prog = Program(ctx)
    first, records, walls = prog.first_steps()
    cycle = prog.tcfg.lazy_generator_regularization
    cycle_s = (cycle - 1) * walls[-2] + walls[-1]
    n_cycles = max(1, round(ctx.seconds / cycle_s)) if not ctx.trace else ctx.traffic[
        "trace_cycles"]
    readings: Dict[str, object] = {}
    census = kernels.Census() if ctx.trace else None
    spans = Spans(prog.trainer, ctx.device) if ctx.trace else None
    counters0 = kernels.launch_counters()
    iters, walls_w = 0, []
    with ctx.window():
        if census:
            census.__enter__()
        try:
            for _ in range(n_cycles * cycle):
                t0 = time.perf_counter()
                prog.iterate()
                walls_w.append(time.perf_counter() - t0)
                iters += 1
        finally:
            if census:
                census.__exit__(None, None, None)
    window_s = ctx.window_seconds
    seqs = iters * ctx.traffic["batch"]
    peak = ctx.memory_peak()
    lazy = iters // cycle
    if spans:
        spans.remove()
        counters = {k: v - counters0[k] for k, v in kernels.launch_counters().items()}
        readings.update(
            main_iter_s=statistics.fmean(w for i, w in enumerate(walls_w) if (i + 1) % cycle),
            r1_s=statistics.fmean(spans.r1), path_length_s=statistics.fmean(spans.pl),
            census=dict(census.sites), launches=census.launches(), counters=counters,
            window_s=window_s)
        t0 = time.perf_counter()
        parts = flops.training(ctx.config_with_overrides(), ctx.traffic["batch"])
        ctx.phases["flop_count_s"] = time.perf_counter() - t0
        n_cm = sum(prog.cut_mix[-iters:])
        readings["model_flops"] = flops.add(
            parts["main"], parts["main_cut_mix"], parts["r1"], parts["path_length"],
            weights=[iters - n_cm, n_cm, lazy, lazy])
    n_g = len(list(prog.trainer.state.generator.parameters()))
    prog.free()
    ctx.free_device()
    t0 = time.perf_counter()
    ref = reference_steps(ctx, records, ctx.traffic["check_steps"])
    ctx.phases["reference_s"] = time.perf_counter() - t0
    numbers = compare(first, ref, n_g)
    return {"attempted": iters, "failed": 0, "numbers": numbers, "peak": peak,
            "end_to_end": {"train_seqs_per_s": seqs / window_s}, "readings": readings,
            "lazy_iterations": lazy, "sequences": seqs}


class Spans:
    """The traced run's synchronised spans around R1 (``r1_update``) and the
    path-length ladder (``Trainer.path_length``), in seconds."""

    def __init__(self, trainer, device):
        self.trainer, self.device = trainer, device
        self.r1: List[float] = []
        self.pl: List[float] = []
        step_fn = trainer.step_fn
        self._r1, self._pl = step_fn.r1_update, trainer.path_length
        step_fn.r1_update = self._timed(self._r1, self.r1)
        trainer.path_length = self._timed(self._pl, self.pl)

    def _timed(self, fn, into):
        def call(*a, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(self.device)
            into.append(time.perf_counter() - t0)
            return out
        return call

    def remove(self) -> None:
        del self.trainer.step_fn.r1_update
        self.trainer.path_length = self._pl


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

