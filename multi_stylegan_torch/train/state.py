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

Everything stays on the device: the skip is decided there from a device
flag, so a step needs no host sync.  Parameters, moments and both counters
update in place.  The step itself is ``ops/fused_optim.py``: on the card
two multi-tensor launches over every leaf, on the CPU the plain per-leaf
loop it is held against.

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
from multi_stylegan_torch.ops import fused_optim
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
        self.tables: Optional[fused_optim.AdamTables] = None  # the kernels', on the card

    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """Apply one update from ``grads`` (aligned with ``self.params``;
        None = zero).  Returns the device flag of whether it was applied."""
        fused = self.params[0].device.type == "cuda"
        with span("train.adam", leaves=len(self.params), fused=fused):
            sharded = [d is not None for d in self.shard_dims]
            applied, self.tables = fused_optim.clipped_adam(
                self.params, self.exp_avg, self.exp_avg_sq, grads, self.count,
                self.notfinite_count, [lr for params, lr in self.groups for _ in params],
                sharded, self.hyper(), mesh.model_sum if any(sharded) else None, self.tables)
            return applied

    def hyper(self) -> fused_optim.AdamHyper:
        """The step's scalars."""
        return fused_optim.AdamHyper(self.b1, self.b2, self.eps, self.max_norm,
                                     self.skip_nonfinite, self.max_consecutive_nonfinite)

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
