"""Training state and the two optimizers.

The optimizer is the JAX package's optax chain (train/state.py:59-101):
``apply_if_finite(chain(clip_by_global_norm(5), adam(b1=0, b2=0.999,
eps=1e-8)))``, with the generator's style mapping in its own Adam group at
lr x 0.01 (reference train_multi_stylegan.py:53-57,
multi_stylegan_generator.py:97-112).  Written out here because PyTorch's
pieces differ where it matters:

* optax scales by max_norm / ||g|| only when ||g|| >= max_norm, with no eps
  (``clip_grad_norm_`` adds 1e-6 and scales below the norm too), over ALL
  of a model's gradients jointly;
* a step whose raw gradients hold a non-finite value is skipped: no
  parameter moves and the Adam moments and step count stay as they were,
  for up to ``max_consecutive_nonfinite`` bad steps in a row; after that it
  is applied anyway, as ``optax.apply_if_finite`` does.

Everything stays on the device: the skip is a ``torch.where`` on a device
flag, so a step needs no host sync.  Parameters update in place.

Under tensor parallelism (parallel/tensor.py) a sharded parameter, its
gradient and its moments are this rank's block: the global norm adds the
replicated leaves' sum of squares to the blocks' sums over the model axis,
and a non-finite value on any model rank skips the step on all of them, as
``optax`` sees the whole sharded array.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from multi_stylegan_torch.models.config import TrainingConfig
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.parallel import tensor as tp
from multi_stylegan_torch.train.ada import AdaState
from multi_stylegan_torch.utils.profiling import span


class ClippedAdam:
    """Global-norm clip, then Adam per parameter group, under a finite guard;
    ``shard_dims`` gives each parameter's tensor-parallel dim (None where
    replicated)."""

    def __init__(self, groups: Sequence[Tuple[Sequence[nn.Parameter], float]], *,
                 b1: float = 0.0, b2: float = 0.999, eps: float = 1e-8,
                 max_norm: float = 5.0, skip_nonfinite: bool = True,
                 max_consecutive_nonfinite: int = 100,
                 shard_dims: Optional[Sequence[Optional[int]]] = None):
        self.groups = [(list(params), float(lr)) for params, lr in groups]
        self.params: List[nn.Parameter] = [p for params, _ in self.groups for p in params]
        self.shard_dims = list(shard_dims or [None] * len(self.params))
        self.b1, self.b2, self.eps, self.max_norm = b1, b2, eps, max_norm
        self.skip_nonfinite = skip_nonfinite
        self.max_consecutive_nonfinite = max_consecutive_nonfinite
        dev = self.params[0].device
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update from ``grads`` (aligned with ``self.params``;
        None = zero).  Returns the device flag of whether it was applied."""
        with span("train.adam", leaves=len(self.params)):
            grads = [torch.zeros_like(p) if g is None else g.detach()
                     for p, g in zip(self.params, grads)]
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            squares = [g.float().square().sum() for g in grads]
            if any(d is not None for d in self.shard_dims):
                rep = sum(q for q, d in zip(squares, self.shard_dims) if d is None)
                blocks = mesh.model_sum(torch.stack([
                    sum(q for q, d in zip(squares, self.shard_dims) if d is not None),
                    (~finite).float()]))
                g_norm = torch.sqrt(rep + blocks[0])
                finite = blocks[1] == 0
            else:
                g_norm = torch.sqrt(sum(squares))
            if self.skip_nonfinite:
                self.notfinite_count = torch.where(
                    finite, torch.zeros_like(self.notfinite_count), self.notfinite_count + 1)
                apply = finite | (self.notfinite_count > self.max_consecutive_nonfinite)
            else:
                apply = torch.ones((), dtype=torch.bool, device=finite.device)
            clip = g_norm >= self.max_norm
            count = torch.where(apply, self.count + 1, self.count)
            bc1 = 1.0 - self.b1 ** count.float()
            bc2 = 1.0 - self.b2 ** count.float()
            lrs = [lr for params, lr in self.groups for _ in params]
            for i, (p, g, lr) in enumerate(zip(self.params, grads, lrs)):
                g = torch.where(clip, g / g_norm * self.max_norm, g)
                mu = (1.0 - self.b1) * g + self.b1 * self.exp_avg[i]
                nu = (1.0 - self.b2) * g.square() + self.b2 * self.exp_avg_sq[i]
                update = -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
                p.copy_(torch.where(apply, p + update, p))
                self.exp_avg[i] = torch.where(apply, mu, self.exp_avg[i])
                self.exp_avg_sq[i] = torch.where(apply, nu, self.exp_avg_sq[i])
            self.count = count
        return apply

    def state_dict(self) -> dict:
        """The Adam moments (aligned with ``params``) and both counters."""
        return {"exp_avg": list(self.exp_avg), "exp_avg_sq": list(self.exp_avg_sq),
                "count": self.count, "notfinite_count": self.notfinite_count}

    def full_state_dict(self) -> dict:
        """:meth:`state_dict` in the one-process layout (every model rank
        takes part in gathering the sharded moments)."""
        out = self.state_dict()
        for key in ("exp_avg", "exp_avg_sq"):
            out[key] = [tp.full_tensor(m, d) for m, d in zip(out[key], self.shard_dims)]
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into this optimizer's tensors in place
        (a one-process layout's moment as this rank's block)."""
        for key in ("exp_avg", "exp_avg_sq"):
            for dst, src, d in zip(getattr(self, key), state[key], self.shard_dims):
                dst.copy_(tp.local_block(src, dst, d))
        self.count.copy_(state["count"])
        self.notfinite_count.copy_(state["notfinite_count"])


def make_generator_optimizer(generator: nn.Module, cfg: TrainingConfig) -> ClippedAdam:
    """Style mapping at lr x lr_style_factor, everything else at lr."""
    style = list(generator.style_mapping.parameters())
    ids = {id(p) for p in style}
    main = [p for p in generator.parameters() if id(p) not in ids]
    return ClippedAdam(
        [(main, cfg.lr_generator), (style, cfg.lr_generator * cfg.lr_style_factor)],
        shard_dims=tp.shard_dims(generator, main + style), **_adam_kw(cfg))


def make_discriminator_optimizer(discriminator: nn.Module, cfg: TrainingConfig) -> ClippedAdam:
    params = list(discriminator.parameters())
    return ClippedAdam([(params, cfg.lr_discriminator)],
                       shard_dims=tp.shard_dims(discriminator, params), **_adam_kw(cfg))


def _adam_kw(cfg: TrainingConfig) -> dict:
    return dict(b1=cfg.adam_beta1, b2=cfg.adam_beta2, max_norm=cfg.grad_clip_norm,
                skip_nonfinite=cfg.skip_nonfinite_updates,
                max_consecutive_nonfinite=cfg.max_consecutive_nonfinite)


@dataclasses.dataclass
class TrainState:
    """Everything a training run carries (the JAX TrainState's fields): the
    1-based step counter, the models (their parameters and the generator's
    noise buffers), the EMA generator, both optimizers, the ADA controller
    and the path-length running mean (a device tensor)."""

    step: int
    generator: nn.Module
    g_ema: nn.Module
    discriminator: nn.Module
    g_opt: ClippedAdam
    d_opt: ClippedAdam
    ada: AdaState
    mean_path_length: torch.Tensor


def create_train_state(generator: nn.Module, discriminator: nn.Module,
                       cfg: TrainingConfig) -> TrainState:
    """A fresh state around the given (initialised) models, on their device."""
    dev = next(generator.parameters()).device
    g_ema = copy.deepcopy(generator).requires_grad_(False)
    return TrainState(
        step=0, generator=generator, g_ema=g_ema, discriminator=discriminator,
        g_opt=make_generator_optimizer(generator, cfg),
        d_opt=make_discriminator_optimizer(discriminator, cfg),
        ada=AdaState.create(cfg.ada_p_init, device=dev),
        mean_path_length=torch.zeros((), device=dev))
