"""Exponential moving average of the generator's parameters (reference
multi_stylegan/misc.py:183-199): parameters only, buffers are not averaged."""

from __future__ import annotations

from torch import nn

from multi_stylegan_torch.ops import fused_optim
from multi_stylegan_torch.utils.profiling import span


def ema_update(ema: nn.Module, model: nn.Module, decay: float = 0.999) -> None:
    """p_ema <- decay * p_ema + (1 - decay) * p, in place: one launch over
    every leaf on the card (ops/fused_optim.py), the plain loop on the CPU."""
    ema_params = list(ema.parameters())
    with span("train.ema", fused=ema_params[0].device.type == "cuda"):
        fused_optim.ema_update(ema_params, list(model.parameters()), decay)
