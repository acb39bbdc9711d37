"""The port's per-iteration schedule (``multi_stylegan_torch/train/loop.py``:
``schedule_coin``, ``top_k_iterations``, the epoch flags and
``Trainer._run_step``) in one process, the path-length update in chunks of
the same draws (the port's chunked form, train/steps.py::path_length_sums),
so that the reference fits beside nothing larger than one chunk."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gpu_bench.reference.config import TrainingConfig
from gpu_bench.reference.state import TrainState
from gpu_bench.reference.steps import StepFlags, TrainStep


def schedule_coin(seed: int, step: int) -> float:
    """The cut-mix coin of ``step``: a uniform draw from (seed, step)."""
    return float(np.random.default_rng((np.uint64(seed), np.uint64(step))).random())


def top_k_iterations(cfg: TrainingConfig, total_steps: int) -> Tuple[int, int]:
    if cfg.top_k and not cfg.resume_training:
        return int(cfg.top_k_start * total_steps), int(cfg.top_k_finish * total_steps)
    if cfg.top_k:
        return 0, 1
    return total_steps + 1, 0


def epoch_flags(cfg: TrainingConfig, epoch: int, epochs: int) -> Tuple[bool, bool, float]:
    """(wrong order, trap weights, cut-mix probability) of an epoch."""
    resume = cfg.resume_training
    wrong_order = (epoch >= cfg.wrong_order_start * epochs) or resume
    trap = (cfg.trap_weight_start * epochs <= epoch) or resume
    return wrong_order, trap, 0.5 if resume else (0.5 / epochs) * epoch


def step_flags(cfg: TrainingConfig, step: int, wrong_order: bool, trap: bool,
               cut_mix_prob: float) -> Tuple[StepFlags, bool, bool]:
    """The flags of ``step`` and whether R1 and path length run on it."""
    flags = StepFlags(wrong_order=wrong_order, trap_weight=trap,
                      do_cut_mix=schedule_coin(cfg.seed, step) <= cut_mix_prob,
                      do_ema=step % cfg.lazy_generator_regularization != 0)
    return (flags, step % cfg.lazy_discriminator_regularization == 0,
            step % cfg.lazy_generator_regularization == 0)


def run_step(step_fn: TrainStep, state: TrainState, real: torch.Tensor, flags: StepFlags,
             lazy_d: bool, lazy_g: bool, draws, pl_chunks: int) -> Dict[str, torch.Tensor]:
    """The main step, then R1 and the path-length update on their steps."""
    metrics = step_fn.main_step(state, real, flags, draws)
    zero = torch.zeros((), device=real.device)
    metrics["loss_discriminator_regularization"] = (
        step_fn.r1_update(state, real) if lazy_d else zero)
    if lazy_g:
        pld = step_fn.draw_path_length(state.generator, step_fn.cfg.batch_size, draws)
        grads, pen, pl, new_mean = step_fn.path_length_grads(state, pld, pl_chunks)
        step_fn.path_length_apply(state, grads, new_mean)
    else:
        pen = pl = zero
    metrics.update(loss_path_length_regularization=pen, path_length=pl)
    return metrics
