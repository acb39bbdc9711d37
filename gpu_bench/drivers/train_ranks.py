"""Driver of the training cells over data ranks: ``drivers/train.py``'s
closed loop of whole lazy cycles, run by one rank a card through the port's
own launcher (``parallel/mesh.py::spawn``, the path of the training CLI and
the soak), each rank on its rows of every global batch of ``batch``.

Every rank makes the same weights, the same global real batches (keeping
its rows, device-resident) and the same seeded global draws (keeping its
rows through the port's ``ShardDraws``), as one process at the global
batch would.  The ranks agree on the window's cycles (rank 0's count from
its set-up steps); the window opens and closes at barriers and runs on rank
0's host clock, which gives ``train_seqs_per_s`` (global sequences over the
window) and ``setup_s`` (from this process's start to the window's).  Only
rank 0 runs the profiler: the traced run reads its ``train.step`` and
``ranks.all_reduce`` spans inside the rank, where the program keeps them.

``correct``: after the window every rank works the set-up steps out again
with the plain reference over the same ranks (``reference/ranked.py`` in
place of ``single.py``: plain ``torch.distributed`` all-reduces, the
minibatch statistic summed over the ranks as the port sums it), and rank 0
compares the two as ``drivers/train.py`` does.

    python3 -m gpu_bench.drivers.train_ranks --workload <cell> --seeds 10 \\
        --control 3 --faults 3 --out cal.jsonl

calibrates ``correct``'s limits over the cell's ranks (``calibrate.py``'s
readings: the program on many seeds, the fp8 control and the half-batch
fault on a few).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time
from typing import List, Optional

import torch

from gpu_bench import bench, calibrate, control, flops, spans
from gpu_bench.drivers import train
from gpu_bench.reference.draws import Replay
from gpu_bench.reference.inputs import real_batches, trap_weights_map
from gpu_bench.reference.weights import make_weights


def spawn(ctx, job: dict) -> object:
    """Rank 0's result of ``job`` run by one rank a chip."""
    from multi_stylegan_torch.parallel import mesh

    # by its package name, so that the spawned ranks find it
    body = importlib.import_module("gpu_bench.drivers.train_ranks").rank_main
    job = dict(job, cell=ctx.cell.name, traffic=ctx.traffic, overrides=ctx.overrides)
    return mesh.spawn(body, (job,), ctx.cell.chips, torch.device(ctx.device.type))


def run(ctx) -> dict:
    start = sys.modules[type(ctx).__module__].START  # this process's start
    out = spawn(ctx, {"seed": ctx.seed, "seconds": ctx.seconds, "trace": ctx.trace,
                      "start_wall": time.time() - (time.perf_counter() - start)})
    ctx.setup_s, ctx.window_seconds = out.pop("setup_s"), out.pop("window_s")
    ctx.trace_summary = out.pop("trace")
    ctx.phases.update(out.pop("phases"))
    if ctx.trace:
        parts = flops.training(ctx.config_with_overrides(), ctx.traffic["batch"] // ctx.cell.chips)
        n_cm, lazy, iters = out["cut_mix"], out["lazy_iterations"], out["attempted"]
        out["readings"]["model_flops"] = flops.add(
            parts["main"], parts["main_cut_mix"], parts["r1"], parts["path_length"],
            weights=[ctx.cell.chips * n for n in (iters - n_cm, n_cm, lazy, lazy)])
    return out


# --------------------------------------------------------------- one rank


def rank_main(device: torch.device, job: dict):
    """One rank's part of ``job``: the cell's run, or (``seeds`` given) the
    calibration's readings."""
    from multi_stylegan_torch.parallel import mesh

    from gpu_bench.reference import ranked

    ranked.install()
    if "seeds" in job:
        return calibrate_rank(device, job)
    cell = _cell(job)
    ctx = _context(cell, job, job["seed"], device, trace=job["trace"] and mesh.rank() == 0)
    return train_rank(ctx, job)


def _cell(job: dict) -> bench.Cell:
    cell = bench.find_cell(job["cell"])
    cell.traffic = job["traffic"]
    return cell


def _context(cell, job: dict, seed: int, device, trace: bool = False):
    from gpu_bench.run import Context

    return Context(cell, seed, job.get("seconds", 0.0), trace, device,
                   bench.OUT / cell.name, job["overrides"])


class RankProgram(train.Program):
    """``train.Program`` on this rank's rows: its share of every global real
    batch, and its rows of the global draws."""

    def __init__(self, ctx):
        from multi_stylegan_torch.parallel import mesh
        from multi_stylegan_torch.train.draws import ShardDraws

        super().__init__(ctx)
        self.batches[:] = [b[mesh.rows(b.shape[0])].clone() for b in self.batches]
        self.trainer.draws = ShardDraws(self.draws)


def train_rank(ctx, job: dict) -> dict:
    from multi_stylegan_torch.parallel import mesh

    prog = RankProgram(ctx)
    first, records, walls = prog.first_steps()
    cycle = prog.tcfg.lazy_generator_regularization
    cycle_s = (cycle - 1) * walls[-2] + walls[-1]
    n_cycles = mesh.broadcast_object(ctx.traffic["trace_cycles"] if job["trace"]
                                     else max(1, round(ctx.seconds / cycle_s)))
    iters = 0
    mesh.barrier()
    with ctx.window():
        setup_s = time.time() - job["start_wall"]
        for _ in range(n_cycles * cycle):
            prog.iterate()
            iters += 1
        mesh.barrier()
    window_s = ctx.window_seconds
    peak = ctx.memory_peak()
    readings = {}
    if ctx.trace:
        traced = {"cell": ctx.cell}
        readings = {"step_span_ms": spans.per_main_iteration(traced, ("train.step",)),
                    "allreduce_ms": spans.per_main_iteration(traced, ("ranks.all_reduce",)),
                    "window_s": window_s, "ranks": mesh.world()}
    n_cm = sum(prog.cut_mix[-iters:])
    n_g = len(list(prog.trainer.state.generator.parameters()))
    prog.free()
    ctx.free_device()
    t0 = time.perf_counter()
    ref = reference_steps(ctx, records, ctx.traffic["check_steps"])
    ctx.phases["reference_s"] = time.perf_counter() - t0
    seqs = iters * ctx.traffic["batch"]
    return {"attempted": iters, "failed": 0, "numbers": train.compare(first, ref, n_g),
            "peak": peak, "end_to_end": {"train_seqs_per_s": seqs / window_s},
            "readings": readings, "lazy_iterations": iters // cycle, "cut_mix": n_cm,
            "sequences": seqs, "setup_s": setup_s, "window_s": window_s,
            "trace": ctx.trace_summary, "phases": ctx.phases}


def reference_steps(ctx, records, n_steps: int) -> dict:
    """``train.reference_steps`` over the ranks: this rank's rows of the same
    global batches and draws, the reductions of ``reference/ranked.py``."""
    from gpu_bench.bench import reference_configs
    from gpu_bench.reference import loop, ranked
    from gpu_bench.reference.discriminator import Discriminator
    from gpu_bench.reference.generator import Generator
    from gpu_bench.reference.state import create_train_state
    from gpu_bench.reference.steps import TrainStep

    t, dev = ctx.traffic, ctx.device
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gcfg, dcfg, tcfg = reference_configs(
        ctx.config, training={"batch_size": t["batch"], "seed": t["schedule_seed"]},
        **ctx.overrides)
    s = train.seeds(ctx.seed)
    gen, disc = Generator(gcfg, device=dev), Discriminator(dcfg, device=dev)
    make_weights([gen, disc], s["weights"])
    shape = (gcfg.num_domains, gcfg.sequence_length, *gcfg.resolution)
    batches = [ranked.shard(b).clone() for b in
               real_batches(t["real_batches"], t["batch"], shape, s["data"], dev)[:n_steps]]
    state = create_train_state(gen, disc, tcfg)
    start, final = loop.top_k_iterations(tcfg, len(batches))
    step_fn = TrainStep(tcfg, top_k_start_iteration=start, top_k_final_iteration=final,
                        trap_weights_map=torch.as_tensor(trap_weights_map(gcfg.resolution)))
    draws = ranked.ShardReplay(Replay(records, dev))
    wrong_order, trap, cm_prob = loop.epoch_flags(tcfg, 0, 1)
    state.step = t["first_step"]
    pl_chunks = train.reference_chunks(step_fn.path_length_batch(tcfg.batch_size))
    rec = train.Recorder(state)
    for real in batches:
        flags, lazy_d, lazy_g = loop.step_flags(tcfg, state.step + 1, wrong_order, trap,
                                                cm_prob)
        metrics = loop.run_step(step_fn, state, real, flags, lazy_d, lazy_g, draws, pl_chunks)
        rec.losses.append({k: float(v) for k, v in metrics.items()})
    return rec.finish()


# ---------------------------------------------------------------- calibration


def calibrate_rank(device, job: dict) -> List[dict]:
    """Each seed's readings over the ranks (``calibrate.train_readings``):
    the program's numbers, the half-batch fault's and the fp8 control's
    against the reference; rank 0 appends each seed's line to ``out``."""
    from multi_stylegan_torch.parallel import mesh

    cell = _cell(job)
    lines = []
    for i, seed in enumerate(job["seeds"]):
        ctx = _context(cell, job, seed, device)
        line = {"workload": cell.name, "seed": seed, "ranks": mesh.world()}
        for kind in ["program"] + (["half_batch"] if i < job["faults"] else []):
            fault = calibrate.half_batch_mean() if kind == "half_batch" else (
                contextlib.nullcontext())
            with fault:
                prog = RankProgram(ctx)
                first, records, _ = prog.first_steps()
                n_g = len(list(prog.trainer.state.generator.parameters()))
                prog.free()
            ctx.free_device()
            ref = reference_steps(ctx, records, ctx.traffic["check_steps"])
            line[kind] = train.candidates(first, ref, n_g)
            if kind == "program" and i < job["control"]:
                with control.fp8_operands():
                    ctl = reference_steps(ctx, records, ctx.traffic["check_steps"])
                line["control"] = train.candidates(ctl, ref, n_g)
            ctx.free_device()
        lines.append(line)
        if mesh.rank() == 0 and job.get("out"):
            with open(job["out"], "a") as f:
                f.write(json.dumps(line) + "\n")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    from gpu_bench.run import Context

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first", type=int, default=calibrate.SEED0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(bench.OUT / "triton")
    cell = bench.find_cell(args.workload)
    ctx = Context(cell, 0, 0.0, False, torch.device("cuda"), bench.OUT / cell.name)
    n = max(args.seeds, args.control, args.faults)
    lines = spawn(ctx, {"seeds": [args.first + 7919 * i for i in range(n)],
                        "control": args.control, "faults": args.faults,
                        "out": os.path.abspath(args.out) if args.out else None})
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
