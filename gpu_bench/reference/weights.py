"""The models' weights, made on their device from the seed in one draw.

Applied alike to the port's modules and the reference's (the same names and
shapes), so both sides start from the same numbers without either taking a
tensor the other made.  Every conv and linear weight is N(0, 1) (the
equalized layers scale at run time), every fixed-noise buffer N(0, 1), and every
other leaf its constructor's value plus 0.2 N(0, 1): the biases, noise
strengths, NonLocal gammas and constant inputs all nonzero, so that every
path of the networks does work.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch
from torch import nn


def leaves(model: nn.Module) -> List[Tuple[str, torch.Tensor, bool]]:
    """(name, tensor, is a noise buffer) of every parameter and of the
    generator's fixed-noise buffers, in order (the blur taps, the other
    buffers, are fixed by the architecture and left alone)."""
    out = [(n, p, False) for n, p in model.named_parameters()]
    return out + [(n, b, True) for n, b in model.named_buffers() if n.startswith("noises.")]


@torch.no_grad()
def make_weights(models: Iterable[nn.Module], seed: int) -> None:
    """Fill ``models`` in place (in this order) from ``seed``."""
    items = [leaf for m in models for leaf in leaves(m)]
    device = items[0][1].device
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(t.numel() for _, t, _ in items)
    draw = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, t, noise in items:
        n = draw[at:at + t.numel()].view(t.shape).to(t.dtype)
        at += t.numel()
        if noise or (name.endswith("weight") and t.dim() >= 2):
            t.copy_(n)
        else:
            t.add_(0.2 * n)
