"""The inputs the benchmark makes from the seed for both sides: the real
batches and the trap-region pixel-weight map."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def real_batches(n: int, batch: int, shape: Tuple[int, ...], seed: int,
                 device: torch.device) -> List[torch.Tensor]:
    """``n`` distinct real batches [batch, *shape] in [-1, 1], on ``device``,
    from one draw: smooth images (a 4x-upsampled field plus fine noise), so
    that the discriminator sees structure at every scale."""
    gen = torch.Generator(device=device).manual_seed(seed)
    *lead, h, w = shape
    coarse = torch.rand((n * batch, int(np.prod(lead)), h // 4, w // 4), generator=gen,
                        device=device)
    fine = torch.rand((n * batch, int(np.prod(lead)), h, w), generator=gen, device=device)
    images = torch.nn.functional.interpolate(coarse, scale_factor=4, mode="bilinear",
                                             align_corners=False)
    images = (0.8 * images + 0.2 * fine) * 2.0 - 1.0
    return list(images.reshape(n, batch, *shape).contiguous().unbind(0))


def trap_weights_map(resolution: Tuple[int, int]) -> np.ndarray:
    """[H, W] f32, mean 1: weight 2 in the central half box, 1 beyond a
    cosine ramp of a quarter of the half extent (the port's default map)."""
    h, w = resolution
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    half = min(h, w) / 2.0
    yy = np.abs(np.arange(h, dtype=np.float32) - cy)
    xx = np.abs(np.arange(w, dtype=np.float32) - cx)
    d = np.maximum(yy[:, None], xx[None, :]) - 0.5 * half
    t = np.clip(d / (0.25 * half), 0.0, 1.0)
    weights = (1.0 + 0.5 * (1.0 + np.cos(np.pi * t))).astype(np.float32)
    return weights / weights.mean()
