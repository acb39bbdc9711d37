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
* R1 and path length run in f32 because the whole trainer does: the port
  trains f32 models only (bf16 training is not ported yet);
* ``r1_update`` takes R1's penalty from one D forward; the JAX ``r1_step``
  also runs a second forward for predictions that split mode discards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from multi_stylegan_torch.models.config import TrainingConfig
from multi_stylegan_torch.models.discriminator import (
    generate_cut_mix_augmentation_data,
    generate_cut_mix_transformation_data,
)
from multi_stylegan_torch.train import losses
from multi_stylegan_torch.train.ada import augment_sequences, calc_r, update_ada_state
from multi_stylegan_torch.train.ema import ema_update
from multi_stylegan_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepFlags:
    """Per-step control the host computes from the epoch schedule
    (model_wrapper.py:272, 331-332).  ``do_ema`` is off on path-length
    steps, whose update applies the EMA after its own parameter change."""

    wrong_order: bool = False
    do_cut_mix: bool = False
    do_ema: bool = True


class TrainStep:
    """The sub-steps of one iteration for a generator / discriminator pair."""

    def __init__(self, cfg: TrainingConfig, *, top_k_start_iteration: int = 0,
                 top_k_final_iteration: int = 1):
        self.cfg = cfg
        self.top_k_start = top_k_start_iteration
        self.top_k_final = top_k_final_iteration

    # ------------------------------------------------------------- helpers

    def build_wplus(self, generator, batch: int, draws) -> torch.Tensor:
        """Two mapped latents mixed at a drawn slot with probability
        p_mixed_noise (JAX steps.py:117-125)."""
        gcfg = generator.config
        z1, z2, use_mix = draws.latents(batch, gcfg.latent_dimensions, self.cfg.p_mixed_noise)
        w1, w2 = generator.map_latent(z1), generator.map_latent(z2)
        inject = torch.where(use_mix, draws.inject_index(gcfg.n_latents),
                             torch.full_like(use_mix, gcfg.n_latents, dtype=torch.long))
        return generator.make_wplus(w1, w2, inject)

    def sample_fakes(self, generator, batch: int, draws) -> torch.Tensor:
        wplus = self.build_wplus(generator, batch, draws)
        return generator.synthesize(wplus, draws.noise(batch, generator._noise_shapes()))

    def _d_ada(self, state: TrainState, images: torch.Tensor, draws):
        b, _, _, h, w = images.shape
        return state.discriminator(augment_sequences(images, draws.ada(b, h, w, state.ada.p)))

    def _update_ada(self, state: TrainState, r: torch.Tensor) -> None:
        cfg = self.cfg
        if cfg.ada:
            state.ada = update_ada_state(state.ada, r, r_target=cfg.ada_r_target,
                                         p_step=cfg.ada_p_step, r_update=cfg.ada_r_update,
                                         p_max=cfg.ada_p_max)

    @staticmethod
    def _grads(loss: torch.Tensor, opt) -> List[torch.Tensor]:
        return list(torch.autograd.grad(loss, opt.params, allow_unused=True))

    # -------------------------------------------------------------- D step

    def d_losses(self, state: TrainState, real: torch.Tensor, wrong_order: bool, draws):
        """The D step's four losses (differentiable in D's params), the fakes,
        the real / fake pixel predictions and the r heuristic's inputs."""
        b = real.shape[0]
        n_wrong = max(1, int(self.cfg.batch_factor_wrong_order * b))
        with torch.no_grad():
            fakes = self.sample_fakes(state.generator, b, draws)
        perm = draws.permutation(real.shape[2])
        pr_s, pr_p = self._d_ada(state, real, draws)
        pf_s, pf_p = self._d_ada(state, fakes, draws)
        all_s, all_p = pf_s, pf_p
        if wrong_order:
            pw_s, pw_p = self._d_ada(state, real[:n_wrong].index_select(2, perm), draws)
            all_s, all_p = torch.cat([pf_s, pw_s]), torch.cat([pf_p, pw_p])
        l_real, l_fake = losses.non_saturating_discriminator_loss(pr_s, all_s)
        l_real_px, l_fake_px = losses.non_saturating_discriminator_loss(pr_p, all_p)
        losses_ = dict(loss_discriminator_real=l_real, loss_discriminator_fake=l_fake,
                       loss_discriminator_real_pixel_wise=l_real_px,
                       loss_discriminator_fake_pixel_wise=l_fake_px)
        return losses_, fakes, pr_p.detach(), pf_p.detach(), calc_r(all_s.detach(), all_p.detach())

    def d_step(self, state: TrainState, real: torch.Tensor, wrong_order: bool, draws):
        """Non-saturating losses on both heads over ADA-augmented reals and
        fakes (+ time-permuted reals when ``wrong_order``); one D update."""
        losses_, fakes, real_pp, fake_pp, r = self.d_losses(state, real, wrong_order, draws)
        state.d_opt.step(self._grads(sum(losses_.values()), state.d_opt))
        self._update_ada(state, r)
        return fakes, real_pp, fake_pp, {k: v.detach() for k, v in losses_.items()}

    # ------------------------------------------------------------- R1 step

    def r1_step(self, state: TrainState, real: torch.Tensor) -> torch.Tensor:
        """R1 on un-augmented reals (f32), one D update; returns the penalty."""
        pen = losses.r1_penalty(state.discriminator, real)
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
        l_reg = (pp - target2).square().mean()
        state.d_opt.step(self._grads(w_reg * l_reg, state.d_opt))
        return l_aug.detach(), l_reg.detach()

    # -------------------------------------------------------------- G step

    def g_step(self, state: TrainState, b: int, draws) -> Metrics:
        """Non-saturating G loss on both heads through ADA, on the top-k
        fakes by D's scalar score."""
        if self.top_k_final > self.top_k_start:
            v = losses.top_k_v(state.step, self.top_k_start, self.top_k_final)
        else:
            v = 1.0
        fakes = self.sample_fakes(state.generator, b, draws)
        pf_s, pf_p = self._d_ada(state, fakes, draws)
        mask, k = losses.top_k_mask(pf_s, v)
        loss_scalar = (F.softplus(-pf_s) * mask).sum() / k
        per_elem = pf_p.numel() // b
        loss_px = (F.softplus(-pf_p) * mask.reshape(b, 1, 1, 1, 1)).sum() / (k * per_elem)
        state.g_opt.step(self._grads(loss_scalar + loss_px, state.g_opt))
        self._update_ada(state, calc_r(pf_s.detach(), pf_p.detach()))
        return dict(loss_generator=loss_scalar.detach(),
                    loss_generator_pixel_wise=loss_px.detach(),
                    top_k_v=torch.tensor(v))

    # ------------------------------------------------------ path-length step

    def path_length_loss(self, state: TrainState, b: int, draws):
        """(penalty, path length, new running mean) on the shrunk batch: f32,
        differentiable in G's params through a double backward."""
        cfg = self.cfg
        g = state.generator
        bs = max(1, int(cfg.batch_size_shrink_path_length_regularization * b))
        noise = draws.noise(bs, g._noise_shapes())
        wplus = self.build_wplus(g, bs, draws)
        gcfg = g.config
        probe = draws.path_length_probe(
            (bs, gcfg.num_domains, gcfg.sequence_length, *gcfg.resolution))
        grads_pl = losses.path_length_grads(lambda wp: g.synthesize(wp, noise), wplus, probe)
        return losses.path_length_penalty(grads_pl, state.mean_path_length, cfg.path_length_decay)

    def path_length_step(self, state: TrainState, b: int, draws):
        """Path-length regularization of G; one G update."""
        pen, pl, new_mean = self.path_length_loss(state, b, draws)
        state.g_opt.step(self._grads(self.cfg.w_generator_regularization * pen, state.g_opt))
        # a non-finite observation must not poison the carried running mean
        state.mean_path_length = torch.where(torch.isfinite(new_mean), new_mean,
                                             state.mean_path_length)
        return pen.detach(), pl.detach()

    # ----------------------------------------------------------- entry points

    def main_step(self, state: TrainState, real: torch.Tensor, flags: StepFlags,
                  draws) -> Metrics:
        """D step, optional cut-mix step, G step, then the EMA unless the
        host runs the path-length update this step."""
        state.step += 1
        fakes, real_pp, fake_pp, metrics = self.d_step(state, real, flags.wrong_order, draws)
        zero = torch.zeros((), device=real.device)
        l_aug = l_reg = zero
        if flags.do_cut_mix:
            l_aug, l_reg = self.cut_mix_step(state, real, fakes, real_pp, fake_pp, draws)
        metrics.update(self.g_step(state, real.shape[0], draws))
        if flags.do_ema:
            ema_update(state.g_ema, state.generator, self.cfg.ema_decay)
        metrics.update(loss_cut_mix_augmentation=l_aug, loss_cut_mix_regularization=l_reg,
                       ada_p=state.ada.p, ada_r=state.ada.last_r)
        return metrics

    r1_update = r1_step  # split mode's name (JAX steps.py:504-506)

    def path_length_update(self, state: TrainState, draws) -> Tuple[torch.Tensor, torch.Tensor]:
        """Path-length step at the configured batch, then the EMA."""
        pen, pl = self.path_length_step(state, self.cfg.batch_size, draws)
        ema_update(state.g_ema, state.generator, self.cfg.ema_decay)
        return pen, pl
