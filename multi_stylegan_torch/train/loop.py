"""The training loop around the step (the core of the JAX package's
``Trainer.train``, train/loop.py:111-374).

Per batch: the epoch's flags (wrong order from 3/4 of the epochs on, a
cut-mix coin whose probability rises linearly to 0.5), ``main_step``, and on
every 16th step R1 and the path-length update, the EMA then following the
path-length update instead of the main step.  The top-k schedule runs over
the middle half of all steps.  Checkpoints, sample grids, validation, the
logger and trap weights are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from multi_stylegan_torch.data.synthetic import iterate_batches
from multi_stylegan_torch.models.config import TrainingConfig
from multi_stylegan_torch.train.state import create_train_state
from multi_stylegan_torch.train.steps import StepFlags, TrainStep


def schedule_coin(seed: int, step: int) -> float:
    """Deterministic per-step uniform draw in [0, 1) for the cut-mix coin,
    a pure function of (seed, step) as in the JAX package (loop.py:111-120)."""
    return float(np.random.default_rng((np.uint64(seed), np.uint64(step))).random())


def top_k_iterations(cfg: TrainingConfig, total_steps: int) -> Tuple[int, int]:
    """(start, final) iterations of the top-k schedule (loop.py:168-176):
    fractions of all steps; a resumed run starts at v = 0.5; without top-k
    the schedule never leaves v = 1."""
    if cfg.top_k and not cfg.resume_training:
        return int(cfg.top_k_start * total_steps), int(cfg.top_k_finish * total_steps)
    if cfg.top_k:
        return 0, 1
    return total_steps + 1, 0


class Trainer:
    """Trains a generator / discriminator pair on a dataset of [C, T, H, W]
    numpy sequences, with the draws from ``draws`` (train/draws.py)."""

    def __init__(self, generator, discriminator, config: TrainingConfig, dataset, draws,
                 epochs: int = 100) -> None:
        self.cfg = config
        self.dataset = dataset
        self.draws = draws
        self.epochs = epochs
        self.device = next(generator.parameters()).device
        total = epochs * (len(dataset) // config.batch_size)
        start, final = top_k_iterations(config, total)
        self.step_fn = TrainStep(config, top_k_start_iteration=start,
                                 top_k_final_iteration=final)
        self.state = create_train_state(generator, discriminator, config)
        self._batch_rng = np.random.default_rng(config.seed)

    def _epoch_flags(self, epoch: int) -> Tuple[bool, float]:
        """(wrong order, cut-mix probability) of an epoch (loop.py:299-305)."""
        cfg = self.cfg
        resume = cfg.resume_training
        wrong_order = (epoch >= cfg.wrong_order_start * self.epochs) or resume
        cut_mix_prob = 0.5 if resume else (0.5 / self.epochs) * epoch
        return wrong_order, cut_mix_prob

    def train(self, on_step: Optional[Callable[[int, Dict[str, float]], None]] = None
              ) -> List[Dict[str, float]]:
        """Run every epoch; returns each step's metrics as host floats."""
        cfg, state, step_fn = self.cfg, self.state, self.step_fn
        history = []
        for epoch in range(self.epochs):
            wrong_order, cm_prob = self._epoch_flags(epoch)
            for batch in iterate_batches(self.dataset, cfg.batch_size, self._batch_rng):
                t0 = time.perf_counter()
                real = torch.from_numpy(batch).to(self.device)
                step = state.step + 1
                lazy_d = step % cfg.lazy_discriminator_regularization == 0
                lazy_g = step % cfg.lazy_generator_regularization == 0
                flags = StepFlags(wrong_order=wrong_order,
                                  do_cut_mix=schedule_coin(cfg.seed, step) <= cm_prob,
                                  do_ema=not lazy_g)
                metrics = step_fn.main_step(state, real, flags, self.draws)
                zero = torch.zeros((), device=self.device)
                metrics["loss_discriminator_regularization"] = (
                    step_fn.r1_update(state, real) if lazy_d else zero)
                pl_pen, pl = (step_fn.path_length_update(state, self.draws) if lazy_g
                              else (zero, zero))
                metrics.update(loss_path_length_regularization=pl_pen, path_length=pl)
                host = {k: float(v) for k, v in metrics.items()}  # waits for the device
                host["seconds"] = time.perf_counter() - t0
                history.append(host)
                if on_step is not None:
                    on_step(state.step, host)
        return history
