"""The GAN training iteration (the JAX package's train/steps.py, split mode).

Per batch the trainer runs :meth:`TrainStep.main_step` (D step, optional
cut-mix step, G step, EMA) and, every 16th step, :meth:`r1_update` and
:meth:`path_length_update` (reference model_wrapper.py:245-451; JAX
steps.py:426-514).  Port decisions:

* the state's modules and optimizers update in place; each sub-step returns
  its metrics as 0-d device tensors, so a step needs no host sync;
* every random draw comes from the provider passed in (train/draws.py);
* the wrong-order side batch is concatenated only when the flag is on, which
  is exactly the JAX step's masked "concat-equivalent" losses;
* with a trap-weight map and the ``trap_weight`` flag on, the D step's
  real and fake pixel losses and the G step's top-k pixel loss weight each
  pixel by the map (JAX steps.py:139-146, 176-188, 289-298);
* the D, cut-mix and G steps run in the models' ``compute_dtype`` (bf16
  under ``--dtype bfloat16``); R1 and path length always run in f32 with
  remat (JAX steps.py:88-100: their grad of grad overflows in bf16).  The
  f32 variants are the same modules and ``Parameter``s called with a
  per-call dtype, so the optimizers and the EMA see one set of tensors;
* ADA warps with the composed affine or, under
  ``TrainingConfig.ada_sequential_warps``, four sequential warps;
* the path-length update splits into :meth:`path_length_grads` (leaves the
  state alone) and :meth:`path_length_apply`, and the grads stage can run
  the batch in chunks (JAX steps.py:524-634): its draws are made once for
  the whole batch (:meth:`draw_path_length`) and sliced per chunk, so every
  chunking sees the sample set of the unchunked step; train/robust.py
  walks the chunkings when memory runs out;
* ``r1_update`` takes R1's penalty from one D forward; the JAX ``r1_step``
  also runs a second forward for predictions that split mode discards;
* under data parallelism (parallel/mesh.py) ``real`` is this rank's rows of
  the global batch, every draw is asked for at the global batch (the
  provider keeps this rank's rows, train/draws.py::ShardDraws), every loss
  and metric is its global value, and every sub-step's gradients are summed
  over the ranks before the update; the wrong-order rows (the first of the
  global batch, all on the first ranks) are re-sharded over every rank
  before their D forward, so no rank skips a forward that the others
  reduce across.  Only the training batch must divide over the ranks: the
  wrong-order and path-length rows, and their draws, fall as
  ``mesh.rows`` lays them out, and a rank may hold none (its forwards then
  run on zero rows and add exact zeros to every reduction);
* under tensor parallelism (parallel/tensor.py) the ranks of a model group
  hold the same rows and draws and run the same step on their blocks of the
  sharded parameters; the update's replicated gradients are averaged over
  them (parallel/mesh.py::all_reduce_grads).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from multi_stylegan_torch.models.config import TrainingConfig
from multi_stylegan_torch.models.discriminator import (
    generate_cut_mix_augmentation_data,
    generate_cut_mix_transformation_data,
)
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.train import losses
from multi_stylegan_torch.train.ada import augment_sequences, calc_r, update_ada_state
from multi_stylegan_torch.train.ema import ema_update
from multi_stylegan_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]

# How R1 and path length call the models (JAX steps.py:88-100).
F32 = dict(compute_dtype="float32", remat=True)


@dataclasses.dataclass
class PathLengthDraws:
    """The draws of one path-length update for its whole batch: the two
    latent sets and the mixing coin, the mixing slot, per-layer noise and
    the probe of the image's shape."""

    latents: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    inject: torch.Tensor
    noise: List[torch.Tensor]
    probe: torch.Tensor
    batch: Optional[int] = None  # the global rows (None: the probe's, in one process)


@dataclasses.dataclass(frozen=True)
class StepFlags:
    """Per-step control the host computes from the epoch schedule
    (model_wrapper.py:272, 290-291, 331-332).  ``do_ema`` is off on
    path-length steps, whose update applies the EMA after its own parameter
    change."""

    wrong_order: bool = False
    trap_weight: bool = False
    do_cut_mix: bool = False
    do_ema: bool = True


class TrainStep:
    """The sub-steps of one iteration for a generator / discriminator pair;
    ``trap_weights_map`` is an optional [H, W] pixel-weight map
    (data/trap_weights.py)."""

    def __init__(self, cfg: TrainingConfig, *, top_k_start_iteration: int = 0,
                 top_k_final_iteration: int = 1,
                 trap_weights_map: Optional[torch.Tensor] = None):
        self.cfg = cfg
        self.top_k_start = top_k_start_iteration
        self.top_k_final = top_k_final_iteration
        self.trap_weights_map = (None if trap_weights_map is None
                                 else torch.as_tensor(trap_weights_map, dtype=torch.float32))

    # ------------------------------------------------------------- helpers

    def build_wplus(self, generator, batch: int, draws) -> torch.Tensor:
        """Two mapped latents mixed at a drawn slot with probability
        p_mixed_noise (JAX steps.py:117-125)."""
        gcfg = generator.config
        latents = draws.latents(batch, gcfg.latent_dimensions, self.cfg.p_mixed_noise)
        return self._wplus(generator, latents, draws.inject_index(gcfg.n_latents))

    @staticmethod
    def _wplus(generator, latents, inject: torch.Tensor) -> torch.Tensor:
        z1, z2, use_mix = latents
        w1, w2 = generator.map_latent(z1), generator.map_latent(z2)
        inject = torch.where(use_mix, inject, torch.full_like(
            use_mix, generator.config.n_latents, dtype=torch.long))
        return generator.make_wplus(w1, w2, inject)

    def sample_fakes(self, generator, batch: int, draws) -> torch.Tensor:
        """This rank's rows of ``batch`` (global) fakes."""
        wplus = self.build_wplus(generator, batch, draws)
        return generator.synthesize(wplus, draws.noise(batch, generator._noise_shapes()))

    def _d_ada(self, state: TrainState, images: torch.Tensor, n: int, draws):
        """D on ADA-augmented ``images``, this rank's rows of a global batch
        of ``n`` (the draws are the global batch's)."""
        h, w = images.shape[-2:]
        return state.discriminator(augment_sequences(
            images, draws.ada(n, h, w, state.ada.p), self.cfg.ada_sequential_warps))

    def _update_ada(self, state: TrainState, r: torch.Tensor) -> None:
        cfg = self.cfg
        if cfg.ada:
            state.ada = update_ada_state(state.ada, r, r_target=cfg.ada_r_target,
                                         p_step=cfg.ada_p_step, r_update=cfg.ada_r_update,
                                         p_max=cfg.ada_p_max)

    def _pixel_weight(self, trap: bool, like: torch.Tensor) -> Optional[torch.Tensor]:
        """The trap map on ``like``'s device when the flag is on, else None."""
        if not trap or self.trap_weights_map is None:
            return None
        return self.trap_weights_map.to(like.device)

    @staticmethod
    def _grads(loss: torch.Tensor, opt) -> List[torch.Tensor]:
        """The parameters' gradients of ``loss``, summed over the ranks."""
        return mesh.all_reduce_grads(torch.autograd.grad(loss, opt.params, allow_unused=True),
                                     opt.shard_dims)

    def wrong_order_batch(self, b: int) -> int:
        """The time-permuted real rows of a (global) training batch of ``b``."""
        return max(1, int(self.cfg.batch_factor_wrong_order * b))

    def check_shards(self, b: int) -> None:
        """Raise unless a (global) training batch of ``b`` divides over the
        data axis, as the JAX mesh requires; the wrong-order and path-length
        rows may fall unevenly (parallel/mesh.py::rows)."""
        w = mesh.world()
        if b % w:
            raise ValueError(f"the training batch {b} does not divide over {w} data ranks")

    # -------------------------------------------------------------- D step

    def d_losses(self, state: TrainState, real: torch.Tensor, wrong_order: bool, draws,
                 trap: bool = False):
        """The D step's four losses (differentiable in D's params), the fakes,
        the real / fake pixel predictions and the r heuristic's inputs."""
        b = real.shape[0] * mesh.world()
        n_wrong = self.wrong_order_batch(b)
        with torch.no_grad():
            fakes = self.sample_fakes(state.generator, b, draws)
        perm = draws.permutation(real.shape[2])
        pr_s, pr_p = self._d_ada(state, real, b, draws)
        pf_s, pf_p = self._d_ada(state, fakes, b, draws)
        all_s, all_p = pf_s, pf_p
        if wrong_order:
            wrong = mesh.head_rows(real, n_wrong).index_select(2, perm)
            pw_s, pw_p = self._d_ada(state, wrong, n_wrong, draws)
            all_s, all_p = torch.cat([pf_s, pw_s]), torch.cat([pf_p, pw_p])
        l_real, l_fake = losses.non_saturating_discriminator_loss(pr_s, all_s)
        l_real_px, l_fake_px = losses.non_saturating_discriminator_loss(
            pr_p, all_p, self._pixel_weight(trap, real))
        losses_ = dict(loss_discriminator_real=l_real, loss_discriminator_fake=l_fake,
                       loss_discriminator_real_pixel_wise=l_real_px,
                       loss_discriminator_fake_pixel_wise=l_fake_px)
        return losses_, fakes, pr_p.detach(), pf_p.detach(), calc_r(all_s.detach(), all_p.detach())

    def d_step(self, state: TrainState, real: torch.Tensor, wrong_order: bool, draws,
               trap: bool = False):
        """Non-saturating losses on both heads over ADA-augmented reals and
        fakes (+ time-permuted reals when ``wrong_order``), the pixel losses
        trap-weighted when ``trap``; one D update."""
        losses_, fakes, real_pp, fake_pp, r = self.d_losses(state, real, wrong_order, draws, trap)
        state.d_opt.step(self._grads(sum(losses_.values()), state.d_opt))
        self._update_ada(state, r)
        return fakes, real_pp, fake_pp, {k: v.detach() for k, v in losses_.items()}

    # ------------------------------------------------------------- R1 step

    def r1_step(self, state: TrainState, real: torch.Tensor) -> torch.Tensor:
        """R1 on un-augmented reals (f32), one D update; returns the penalty."""
        pen = losses.r1_penalty(lambda x: state.discriminator(x, **F32), real)
        state.d_opt.step(self._grads(self.cfg.w_discriminator_regularization_r1 * pen,
                                     state.d_opt))
        return pen.detach()

    # --------------------------------------------------------- cut-mix step

    def cut_mix_step(self, state: TrainState, real, fakes, real_pp, fake_pp, draws):
        """Two D updates: the cut-mix augmentation loss, then the consistency
        regularization against the mixed per-pixel predictions."""
        d, w_reg = state.discriminator, self.cfg.w_discriminator_regularization
        h, w = real.shape[-2:]
        mixed, target = generate_cut_mix_augmentation_data(draws.cut_mix(h, w), real, fakes)
        _, pp = d(mixed)
        l_real, l_fake = losses.non_saturating_discriminator_loss_cut_mix(pp, target)
        l_aug = l_real + l_fake
        state.d_opt.step(self._grads(w_reg * l_aug, state.d_opt))
        mixed2, target2 = generate_cut_mix_transformation_data(
            draws.cut_mix(h, w), real, fakes, real_pp, fake_pp)
        _, pp = d(mixed2)
        l_reg = mesh.global_mean((pp - target2).square())
        state.d_opt.step(self._grads(w_reg * l_reg, state.d_opt))
        return l_aug.detach(), l_reg.detach()

    # -------------------------------------------------------------- G step

    def g_step(self, state: TrainState, batch: int, draws, trap: bool = False) -> Metrics:
        """Non-saturating G loss on both heads through ADA, on the top-k
        fakes (of a global ``batch``) by D's scalar score, the pixel loss
        trap-weighted when ``trap``."""
        if self.top_k_final > self.top_k_start:
            v = losses.top_k_v(state.step, self.top_k_start, self.top_k_final)
        else:
            v = 1.0
        fakes = self.sample_fakes(state.generator, batch, draws)
        b = fakes.shape[0]
        pf_s, pf_p = self._d_ada(state, fakes, batch, draws)
        mask, k = losses.top_k_mask(pf_s, v)
        loss_scalar = mesh.global_total(F.softplus(-pf_s) * mask) / k
        per_elem = pf_p.numel() // b
        raw_px = losses.apply_pixel_weight(F.softplus(-pf_p) * mask.reshape(b, 1, 1, 1, 1),
                                           self._pixel_weight(trap, pf_p))
        loss_px = mesh.global_total(raw_px) / (k * per_elem)
        state.g_opt.step(self._grads(loss_scalar + loss_px, state.g_opt))
        self._update_ada(state, calc_r(pf_s.detach(), pf_p.detach()))
        return dict(loss_generator=loss_scalar.detach(),
                    loss_generator_pixel_wise=loss_px.detach(),
                    top_k_v=torch.tensor(v))

    # ------------------------------------------------------ path-length step

    def path_length_batch(self, b: int) -> int:
        """The shrunk path-length batch for a (global) training batch of ``b``."""
        return max(1, int(self.cfg.batch_size_shrink_path_length_regularization * b))

    def draw_path_length(self, generator, b: int, draws) -> PathLengthDraws:
        """All draws of a path-length update at (global) training batch
        ``b``: this rank's rows of them."""
        gcfg = generator.config
        bs = self.path_length_batch(b)
        noise = draws.noise(bs, generator._noise_shapes())
        latents = draws.latents(bs, gcfg.latent_dimensions, self.cfg.p_mixed_noise)
        inject = draws.inject_index(gcfg.n_latents)
        probe = draws.path_length_probe(
            (bs, gcfg.num_domains, gcfg.sequence_length, *gcfg.resolution))
        return PathLengthDraws(latents, inject, noise, probe, bs)

    def _path_length_grads_wrt_wplus(self, generator, pld: PathLengthDraws,
                                     rows: slice = slice(None)) -> torch.Tensor:
        """grad_w+ (G(w+) . y) of the draws' ``rows`` through the f32 G,
        differentiable again in G's params."""
        z1, z2, use_mix = pld.latents
        wplus = self._wplus(generator, (z1[rows], z2[rows], use_mix), pld.inject)
        noise = [n[rows] for n in pld.noise]
        return losses.path_length_grads(
            lambda wp: generator.synthesize(wp, noise, **F32), wplus, pld.probe[rows])

    def _path_length_penalty(self, state: TrainState, pld: PathLengthDraws):
        grads_pl = self._path_length_grads_wrt_wplus(state.generator, pld)
        return losses.path_length_penalty(grads_pl, state.mean_path_length,
                                          self.cfg.path_length_decay)

    def path_length_loss(self, state: TrainState, b: int, draws):
        """(penalty, path length, new running mean) on the shrunk batch: f32,
        differentiable in G's params through a double backward."""
        return self._path_length_penalty(state, self.draw_path_length(state.generator, b, draws))

    def path_length_grads(self, state: TrainState, pld: PathLengthDraws, n_chunks: int = 1):
        """(G's parameter gradients of the weighted penalty, penalty, path
        length, new running mean) without touching the state.

        With ``n_chunks`` > 1 the batch runs in that many slices of the same
        draws (JAX steps.py:557-634).  The per-sample lengths couple only
        through their mean pl, so the gradient is
        w * 2 (1 - decay) (pl - new mean) / bs * sum_i d pl_i / d theta,
        accumulated chunk by chunk; the running mean is updated once.  Under
        data parallelism every chunking takes that form (the sums of
        :meth:`path_length_sums`, then :meth:`path_length_from_sums`)."""
        if n_chunks == 1 and mesh.process_count() == 1:
            pen, pl, new_mean = self._path_length_penalty(state, pld)
            grads = torch.autograd.grad(self.cfg.w_generator_regularization * pen,
                                        state.g_opt.params, allow_unused=True)
            return list(grads), pen.detach(), pl.detach(), new_mean
        return self.path_length_from_sums(state, *self.path_length_sums(state, pld, n_chunks))

    def path_length_sums(self, state: TrainState, pld: PathLengthDraws, n_chunks: int):
        """(G's parameter gradients of sum_i pl_i, sum_i pl_i, the global
        path-length batch) over this rank's rows of the draws, in
        ``n_chunks`` slices of them (the first ones a row longer where they
        do not divide); no collective, so a rank that runs out of memory
        here leaves the others waiting at nothing (train/robust.py).  An
        empty slice runs nothing, but a rank without rows runs its one empty
        slice."""
        params = state.g_opt.params
        bs = pld.probe.shape[0]
        n = bs if pld.batch is None else pld.batch
        if n % n_chunks:
            raise ValueError(f"path-length batch {n} is not divisible into {n_chunks} chunks")
        acc: List[Optional[torch.Tensor]] = [None] * len(params)
        total = torch.zeros((), device=pld.probe.device)
        per, extra = divmod(bs, n_chunks)
        start = 0
        for i in range(n_chunks):
            rows = slice(start, start + per + (i < extra))
            start = rows.stop
            if i and rows.stop == rows.start:  # the empty slices come last
                break
            s = losses.per_sample_path_lengths(
                self._path_length_grads_wrt_wplus(state.generator, pld, rows)).sum()
            for k, g in enumerate(torch.autograd.grad(s, params, allow_unused=True)):
                if g is not None:
                    acc[k] = g if acc[k] is None else acc[k] + g
            total = total + s.detach()
        return acc, total, n

    def path_length_from_sums(self, state: TrainState, acc, total: torch.Tensor, bs: int):
        """:meth:`path_length_grads`' output from :meth:`path_length_sums`
        over a global path-length batch of ``bs`` rows, summed over the
        ranks."""
        cfg = self.cfg
        pl = mesh.total(total) / bs
        mean = state.mean_path_length.detach()
        new_mean = mean + cfg.path_length_decay * (pl - mean)
        scale = (cfg.w_generator_regularization * 2.0 * (1.0 - cfg.path_length_decay)
                 * (pl - new_mean) / bs)
        # a rank without path-length rows gets None for some of G's
        # parameters the others reach: the reduction allows it
        grads = [None if g is None else scale * g
                 for g in mesh.all_reduce_grads(acc, state.g_opt.shard_dims,
                                                state.g_opt.params)]
        return grads, (pl - new_mean).square(), pl, new_mean

    def _apply_path_length(self, state: TrainState, grads, new_mean: torch.Tensor) -> None:
        state.g_opt.step(grads)
        # a non-finite observation must not poison the carried running mean
        state.mean_path_length = torch.where(torch.isfinite(new_mean), new_mean,
                                             state.mean_path_length)

    def path_length_apply(self, state: TrainState, grads, new_mean: torch.Tensor) -> None:
        """One G update from :meth:`path_length_grads`' output, then the EMA."""
        self._apply_path_length(state, grads, new_mean)
        ema_update(state.g_ema, state.generator, self.cfg.ema_decay)

    def path_length_step(self, state: TrainState, b: int, draws):
        """Path-length regularization of G at training batch ``b``; one G
        update without the EMA (the JAX step of this name)."""
        pld = self.draw_path_length(state.generator, b, draws)
        grads, pen, pl, new_mean = self.path_length_grads(state, pld)
        self._apply_path_length(state, grads, new_mean)
        return pen, pl

    # ----------------------------------------------------------- entry points

    def main_step(self, state: TrainState, real: torch.Tensor, flags: StepFlags,
                  draws) -> Metrics:
        """D step, optional cut-mix step, G step, then the EMA unless the
        host runs the path-length update this step."""
        state.step += 1
        fakes, real_pp, fake_pp, metrics = self.d_step(state, real, flags.wrong_order, draws,
                                                       flags.trap_weight)
        zero = torch.zeros((), device=real.device)
        l_aug = l_reg = zero
        if flags.do_cut_mix:
            l_aug, l_reg = self.cut_mix_step(state, real, fakes, real_pp, fake_pp, draws)
        metrics.update(self.g_step(state, real.shape[0] * mesh.world(), draws, flags.trap_weight))
        if flags.do_ema:
            ema_update(state.g_ema, state.generator, self.cfg.ema_decay)
        metrics.update(loss_cut_mix_augmentation=l_aug, loss_cut_mix_regularization=l_reg,
                       ada_p=state.ada.p, ada_r=state.ada.last_r)
        return metrics

    r1_update = r1_step  # split mode's name (JAX steps.py:504-506)

    def path_length_update(self, state: TrainState, draws) -> Tuple[torch.Tensor, torch.Tensor]:
        """Path-length update at the configured batch, unchunked: the draws,
        :meth:`path_length_grads`, then :meth:`path_length_apply` (G step
        and EMA), as each tier of train/robust.py's ladder runs it."""
        pld = self.draw_path_length(state.generator, self.cfg.batch_size, draws)
        grads, pen, pl, new_mean = self.path_length_grads(state, pld)
        self.path_length_apply(state, grads, new_mean)
        return pen, pl
