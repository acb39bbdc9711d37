"""The training loop around the step (the JAX package's train/loop.py,
``Trainer``; reference model_wrapper.py).

Per batch: the epoch's flags (wrong order from 3/4 of the epochs on, trap
weights from 1/4 on, a cut-mix coin whose probability rises linearly to
0.5; all three at once under ``resume_training``), ``main_step``, and on
every 16th step R1 and the path-length update, the EMA then following the
path-length update instead of the main step.  The path-length update goes
through train/robust.py's ladder of chunkings, which retries it in more
chunks when memory runs out.  The top-k schedule runs over the middle half
of all steps.  Every step's metrics go to the logger.

After every epoch: ``seqs_per_sec``, the fixed-latent sample grids (EMA and
training generator, fixed and random noise), validation every
``validate_every_n_epochs`` and a checkpoint every
``checkpoint_every_n_epochs``.  A failing grid or checkpoint save warns and
training goes on, as in the JAX loop: the last checkpoint stays the restore
point.  With ``profile_dir`` the steps 2 to 5 of the run are traced by
``torch.profiler`` (step 1 warms up), as in the JAX loop.

Under data parallelism (parallel/mesh.py) every rank runs this loop on its
rows of each global batch, from rank 0's initial state, and the ranks stay
replicas.  Only rank 0 writes (metrics, grids, the trace, checkpoints), as
only process 0 does in the JAX loop; the checkpoint holds every data rank's
loader state, and the other ranks wait at a barrier while it is written
(JAX loop.py:423).  Validation runs on every rank over the global batches,
with the same samples everywhere (JAX loop.py:282-288).

Under tensor parallelism (parallel/tensor.py) the Trainer splits the
models' sharded leaves over the model axis before it builds the state, so
the Adam moments and the EMA are blocks too.  A checkpoint keeps the
one-process layout: every rank takes part in gathering the blocks, rank 0
writes them, and a restore keeps each rank's block, so a checkpoint moves
between layouts.  The sample grids run on every rank (their synthesis
gathers channels), and rank 0 writes them.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multi_stylegan_torch.data.pipeline import load_loader_state, loader_state
from multi_stylegan_torch.io.checkpoint import (
    CheckpointManager,
    load_train_state,
    train_state_dict,
)
from multi_stylegan_torch.io.logger import Logger
from multi_stylegan_torch.models.config import TrainingConfig
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.parallel import tensor as tp
from multi_stylegan_torch.train.robust import RobustPathLength
from multi_stylegan_torch.train.state import create_train_state
from multi_stylegan_torch.train.steps import StepFlags, TrainStep
from multi_stylegan_torch.utils.profiling import Trace, span
from multi_stylegan_torch.utils.telemetry import RunTelemetry


PROFILE_STEPS = 4


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
    """Trains a generator / discriminator pair on the batches of ``loader``
    (data/pipeline.py), with the draws from ``draws`` (train/draws.py).
    Checkpoints go to ``checkpoint_dir``, by default the logger's
    ``models/``."""

    def __init__(self, generator, discriminator, config: TrainingConfig, loader, draws,
                 epochs: int = 100, data_logger: Optional[Logger] = None,
                 validation_metrics: Sequence[Callable] = (),
                 trap_weights_map: Optional[np.ndarray] = None,
                 profile_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None) -> None:
        self.cfg = config
        self.loader = loader
        self.draws = draws
        self.epochs = epochs
        self.device = next(generator.parameters()).device
        self.logger = data_logger or Logger()
        self.validation_metrics = tuple(validation_metrics)
        self.best_fvd = float("inf")
        self.profile_dir = profile_dir
        self.trace: Optional[Trace] = None
        start, final = top_k_iterations(config, epochs * len(loader))
        trap = None if trap_weights_map is None else torch.as_tensor(trap_weights_map).to(self.device)
        self.step_fn = TrainStep(config, top_k_start_iteration=start,
                                 top_k_final_iteration=final, trap_weights_map=trap)
        self.step_fn.check_shards(config.batch_size)
        self.path_length = RobustPathLength(self.step_fn)
        tp.shard_model(generator)
        tp.shard_model(discriminator)
        self.state = create_train_state(generator, discriminator, config)
        mesh.broadcast_state(train_state_dict(self.state))
        self.writer = mesh.writes()
        # its own directory lets two runs (a run and its resume) share one
        # (JAX loop.py:250-253)
        self.ckpt = CheckpointManager(checkpoint_dir or self.logger.path_models)
        # fixed validation latents: 15 pairs, always mixed (model_wrapper.py:99-102)
        gen = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        dim = generator.config.latent_dimensions
        self.validation_noise = tuple(
            torch.randn((15, dim), generator=gen, device=self.device) for _ in range(2))

    # ------------------------------------------------------------- sampling

    @torch.no_grad()
    def sample(self, z1: torch.Tensor, z2: Optional[torch.Tensor], generator: torch.Generator,
               ema: bool = True, randomize_noise: bool = True) -> torch.Tensor:
        """Images of the EMA (or training) generator; ``z2`` mixes at a drawn
        layer; ``generator`` draws the mixing layer and the noise."""
        g = self.state.g_ema if ema else self.state.generator
        return g(z1, z2, randomize_noise=randomize_noise, generator=generator)

    # -------------------------------------------------------------- training

    def _epoch_flags(self, epoch: int) -> Tuple[bool, bool, float]:
        """(wrong order, trap weights, cut-mix probability) of an epoch
        (loop.py:299-305)."""
        cfg = self.cfg
        resume = cfg.resume_training
        wrong_order = (epoch >= cfg.wrong_order_start * self.epochs) or resume
        trap = (cfg.trap_weight_start * self.epochs <= epoch) or resume
        cut_mix_prob = 0.5 if resume else (0.5 / self.epochs) * epoch
        return wrong_order, trap, cut_mix_prob

    def _run_step(self, real: torch.Tensor, flags: StepFlags, lazy_d: bool,
                  lazy_g: bool) -> Dict[str, torch.Tensor]:
        state, step_fn = self.state, self.step_fn
        # main_step counts the step first: the span carries the step it runs
        with span("train.step", step=state.step + 1, lazy_d=lazy_d, lazy_g=lazy_g):
            metrics = step_fn.main_step(state, real, flags, self.draws)
            zero = torch.zeros((), device=self.device)
            metrics["loss_discriminator_regularization"] = (
                step_fn.r1_update(state, real) if lazy_d else zero)
            if lazy_g:
                pl_pen, pl, pl_metrics = self.path_length(state, self.draws)
            else:
                pl_pen, pl = zero, zero
                pl_metrics = {"path_length_chunks": zero, "path_length_skipped": zero}
            metrics.update(loss_path_length_regularization=pl_pen, path_length=pl, **pl_metrics)
        return metrics

    def train(self, on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
              max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Run every epoch, or until the state's step reaches ``max_steps``
        (the epoch it stops in then ends there); returns each step's metrics
        as host floats, with the step's ``seconds`` once its batch was there
        and its ``data_wait_seconds`` (the time it waited for the batch)."""
        cfg, state = self.cfg, self.state
        telemetry = RunTelemetry("MultiStyleGAN", self.epochs,
                                 os.path.join(self.logger.path_metrics, "eta.log")
                                 if self.writer else None)
        telemetry.start()
        history = []

        def done() -> bool:
            return max_steps is not None and state.step >= max_steps

        for epoch in range(self.epochs):
            if done():
                break
            wrong_order, trap, cm_prob = self._epoch_flags(epoch)
            t_epoch, n_seqs = time.perf_counter(), 0
            batches = iter(self.loader)
            while not done():
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                real = batch.to(self.device, non_blocking=True)
                t1 = time.perf_counter()
                step = state.step + 1
                if self.profile_dir and step == 2 and self.writer:
                    self.trace = Trace(self.profile_dir)
                    self.trace.start()
                flags = StepFlags(wrong_order=wrong_order, trap_weight=trap,
                                  do_cut_mix=schedule_coin(cfg.seed, step) <= cm_prob,
                                  do_ema=step % cfg.lazy_generator_regularization != 0)
                metrics = self._run_step(real, flags,
                                         step % cfg.lazy_discriminator_regularization == 0,
                                         step % cfg.lazy_generator_regularization == 0)
                host = {k: float(v) for k, v in metrics.items()}  # waits for the device
                seconds = time.perf_counter() - t1
                if self._tracing() and step >= 1 + PROFILE_STEPS:
                    self.trace.stop()
                for name, value in host.items():
                    self.logger.log_metric(name, value)
                host.update(seconds=seconds, data_wait_seconds=t1 - t0)
                history.append(host)
                n_seqs += real.shape[0] * mesh.world()
                if on_step is not None:
                    on_step(state.step, host)
            self.logger.log_metric("seqs_per_sec", n_seqs / max(time.perf_counter() - t_epoch, 1e-9))
            telemetry.step()
            if self.writer or mesh.model_world() > 1:
                self._guarded(lambda: self._save_sample_grids(epoch), epoch, "sample-grid save",
                              "training continues without this epoch's grids")
            if (epoch + 1) % cfg.validate_every_n_epochs == 0:
                self.validation()
            if self.writer:
                self.logger.save()
            if (epoch + 1) % cfg.checkpoint_every_n_epochs == 0:
                self._guarded(self.save_checkpoint, epoch, "checkpoint save",
                              "training continues - the previous checkpoint remains the "
                              "restore point")
        if self._tracing():  # a run shorter than the profile window
            self.trace.stop()
        return history

    def _tracing(self) -> bool:
        return self.trace is not None and self.trace.path is None

    @staticmethod
    def _guarded(fn: Callable[[], object], epoch: int, what: str, consequence: str) -> None:
        """Run an end-of-epoch save; a failure warns instead of ending the
        run (the training state itself is untouched by these saves)."""
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - any failure of a save is reported, not fatal
            warnings.warn(f"{what} failed at epoch {epoch + 1} ({type(exc).__name__}: "
                          f"{str(exc)[:200]}); {consequence}.", RuntimeWarning)

    def _save_sample_grids(self, epoch: int) -> None:
        """Fixed-latent grids of the EMA and the training generator, with
        fixed and with random per-layer noise (model_wrapper.py:147-174)."""
        z1, z2 = self.validation_noise
        for ema, tag in ((True, "prediction_ema"), (False, "prediction")):
            for randomize, name in ((False, f"{tag}_{epoch + 1}"), (True, f"{tag}_rand_{epoch + 1}")):
                images = self.sample(z1, z2, self.grid_generator(epoch), ema=ema,
                                     randomize_noise=randomize)
                if self.writer:
                    self.logger.save_prediction(images.cpu().numpy(), name)

    def grid_generator(self, epoch: int) -> torch.Generator:
        """The draws (mixing layer, noise) of an epoch's grids, a pure
        function of (seed, epoch) as the JAX grids' key (loop.py:450)."""
        seed = int(np.random.SeedSequence([self.cfg.seed + 2, epoch]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------ validation

    def validation(self) -> None:
        """FID / FVD / IS of the EMA generator (model_wrapper.py:197-243),
        logged as ``<Name>_bf`` / ``<Name>_gfp``; tracks the best FVD.  The
        real batches are the global ones on every rank."""
        for metric in self.validation_metrics:
            scores = metric(generator_apply=lambda z1, z2, gen: self.sample(z1, z2, gen),
                            dataset=self.loader if mesh.world() == 1 else self._global_batches())
            name = type(metric).__name__
            scores = (scores,) if np.isscalar(scores) else tuple(scores)
            for channel, score in zip(("bf", "gfp", "rfp"), scores):
                self.logger.log_metric(f"{name}_{channel}", float(score))
            if "FVD" in name and float(scores[0]) < self.best_fvd:
                self.best_fvd = float(scores[0])

    def _global_batches(self):
        """The loader's batches as the global ones (every rank's rows)."""
        for batch in self.loader:
            yield mesh.gather_rows(batch.to(self.device))

    # ------------------------------------------------------- checkpoints

    def checkpoint_payload(self) -> Dict[str, object]:
        """The training state in the one-process layout, the draws'
        generator state and the loader's rng states (under data parallelism
        every data rank's, in rank order)."""
        loader = loader_state(self.loader)
        if mesh.world() > 1:
            loader = mesh.gather_objects(loader)[::mesh.model_world()]
        payload = {"train_state": train_state_dict(self.state, full=True), "loader": loader}
        if hasattr(self.draws, "generator"):
            payload["draws"] = self.draws.generator.get_state()
        return payload

    def save_checkpoint(self) -> Optional[str]:
        """Write the checkpoint (rank 0; every rank takes part in gathering
        it and waits until it is written); returns its path on rank 0."""
        payload = self.checkpoint_payload()
        try:
            return self.ckpt.save(self.state.step, payload) if self.writer else None
        finally:
            mesh.barrier()

    def restore_latest(self, directory: Optional[str] = None) -> bool:
        """Restore the newest checkpoint of ``directory`` (default this
        trainer's checkpoint directory) into the live state, in place; False
        if there is none."""
        ckpt = self.ckpt if directory is None else CheckpointManager(directory)
        if ckpt.latest_step() is None:
            return False
        self.load_payload(ckpt.load())
        return True

    def load_payload(self, saved: Dict[str, object]) -> None:
        """Restore a :meth:`checkpoint_payload` in place; one without the
        loader's or the draws' state (cli/convert.py's) leaves those as they
        are."""
        load_train_state(self.state, saved["train_state"])
        if "loader" in saved:
            load_loader_state(self.loader, _own_loader_state(saved["loader"]))
        if "draws" in saved:
            self.draws.generator.set_state(saved["draws"])


def _own_loader_state(saved) -> Dict[str, object]:
    """This data rank's loader state from a checkpoint's: a run of as many
    data ranks saved one per rank; from another layout only the shared epoch
    order carries over."""
    if isinstance(saved, dict):
        saved = [saved]
    if len(saved) == mesh.world():
        return saved[mesh.rank()]
    return {"sampler": saved[0]["sampler"]}
