"""Exponential moving average of the generator's parameters (reference
multi_stylegan/misc.py:183-199): parameters only, buffers are not averaged."""

from __future__ import annotations

import torch
from torch import nn

from multi_stylegan_torch.utils.profiling import span


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float = 0.999) -> None:
    """p_ema <- decay * p_ema + (1 - decay) * p, in place."""
    with span("train.ema"):
        for e, p in zip(ema.parameters(), model.parameters()):
            e.mul_(decay).add_(p.detach().to(e.dtype) * (1.0 - decay))
