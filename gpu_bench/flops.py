"""Model FLOPs of the window's work, by the precision each operation runs
in, and the whole step's least time at the card's peaks.

Counted on the reference's modules (the port's model math, plain ops) built
on the ``meta`` device, so nothing is computed and no memory is taken: every
convolution and matmul, forward, backward and the double backward of R1 and
path length, at 2 x its multiply-adds from the shapes (torch's own FLOP
formulas, ``torch.utils.flop_counter``).  Recomputation is left out: the
counted modules run without remat.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from gpu_bench.reference.draws import SeededDraws

# Published H100 SXM dense peaks (NVIDIA data sheet, 700 W): bf16 and fp16
# on the tensor cores; f32 convolutions and matmuls against TF32's rate,
# the highest the card reaches on f32 inputs (cuDNN's Winograd and FFT
# algorithms do fewer operations than the direct count, so a share of the
# 67 TFLOP/s f32 rate could pass 100%); anything else at the f32 rate.
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float16": 989e12, "torch.float32": 495e12}
OTHER_PEAK = 67e12


class FlopsByDtype(TorchDispatchMode):
    """Counts the FLOPs of every op torch has a formula for, keyed by the
    dtype of its first tensor argument."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            first = next(a for a in args if isinstance(a, torch.Tensor))
            self.flops[str(first.dtype)] += flop_registry[packet](*args, **kwargs, out_val=out)
        return out


def count(fn: Callable[[], object]) -> Dict[str, int]:
    """FLOPs of running ``fn``, by dtype."""
    with FlopsByDtype() as mode:
        fn()
    return dict(mode.flops)


def least_seconds(flops: Dict[str, float]) -> float:
    """The least time of ``flops`` at the peak of each one's precision."""
    return sum(n / PEAK_FLOPS.get(dtype, OTHER_PEAK) for dtype, n in flops.items())


def add(*parts: Dict[str, float], weights=None) -> Dict[str, float]:
    """Sum of FLOP tables, each times its weight."""
    out: Dict[str, float] = collections.Counter()
    for part, w in zip(parts, weights or [1] * len(parts)):
        for k, v in part.items():
            out[k] += w * v
    return dict(out)


def training(config: dict, batch: int) -> Dict[str, Dict[str, int]]:
    """FLOPs of the training iteration's parts at ``batch``: the main step
    without and with cut-mix, R1 and the path-length update."""
    from gpu_bench.bench import reference_configs
    from gpu_bench.reference.discriminator import Discriminator
    from gpu_bench.reference.generator import Generator
    from gpu_bench.reference.loop import top_k_iterations
    from gpu_bench.reference.state import create_train_state
    from gpu_bench.reference.steps import StepFlags, TrainStep

    meta = torch.device("meta")
    gcfg, dcfg, tcfg = reference_configs(
        config, generator={"remat": False}, discriminator={"remat": False},
        training={"batch_size": batch})
    gen, disc = Generator(gcfg, device=meta), Discriminator(dcfg, device=meta)
    state = create_train_state(gen, disc, tcfg)
    start, final = top_k_iterations(tcfg, 1)
    step = TrainStep(tcfg, top_k_start_iteration=start, top_k_final_iteration=final,
                     trap_weights_map=torch.ones(gcfg.resolution, device=meta))
    draws = MetaDraws()
    real = torch.zeros((batch, gcfg.num_domains, gcfg.sequence_length, *gcfg.resolution),
                       device=meta)
    flags = dict(wrong_order=True, trap_weight=True)

    def pl():
        pld = step.draw_path_length(gen, batch, draws)
        grads, _, _, new_mean = step.path_length_grads(state, pld)
        step.path_length_apply(state, grads, new_mean)

    return {
        "main": count(lambda: step.main_step(state, real, StepFlags(**flags), draws)),
        "main_cut_mix": count(lambda: step.main_step(
            state, real, StepFlags(do_cut_mix=True, **flags), draws)),
        "r1": count(lambda: step.r1_update(state, real)),
        "path_length": count(pl),
    }


def sampling(config: dict, batch: int) -> Dict[str, int]:
    """FLOPs of one sampling batch (mapping and synthesis, the forward)."""
    from gpu_bench.bench import reference_configs
    from gpu_bench.reference.generator import Generator

    meta = torch.device("meta")
    gcfg = reference_configs(config, generator={"remat": False})[0]
    gen = Generator(gcfg, device=meta)
    z = torch.zeros((batch, gcfg.latent_dimensions), device=meta)
    noise = [torch.zeros((batch, 1, h, w), device=meta) for h, w in gen._noise_shapes()]
    with torch.no_grad():
        return count(lambda: gen(z, noise=noise))


class MetaDraws(SeededDraws):
    """The draws protocol on the ``meta`` device: shapes only."""

    def __init__(self):
        self.generator, self.device, self.records = None, torch.device("meta"), None

    def _randn(self, *shape):
        return torch.zeros(shape, device=self.device)

    _rand = _randn

    def _randint(self, lo: int, hi: int, shape=()):
        return torch.zeros(shape, dtype=torch.long, device=self.device)

    def ada(self, batch: int, height: int, width: int, p):
        # a host index: indexing by a 0-d tensor reads it to the host
        return dataclasses.replace(super().ada(batch, height, width, p), rot90_index=0)
