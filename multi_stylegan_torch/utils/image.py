"""Batch image helpers of the evaluation (reference multi_stylegan/misc.py:
216-235; the JAX package's utils/image.py and eval/metrics.py:41-55)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def normalize_0_1_batch(x: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max to [0, 1], clamped below at 1e-3 (the reference's
    quirk: a sample's minimum maps to 1e-3, not 0)."""
    flat = x.reshape(x.shape[0], -1)
    shape = (-1,) + (1,) * (x.dim() - 1)
    mn = flat.min(dim=1).values.reshape(shape)
    mx = flat.max(dim=1).values.reshape(shape)
    return ((x - mn) / (mx - mn)).clamp(min=1e-3)


def normalize_m1_1_batch(x: torch.Tensor) -> torch.Tensor:
    """2 * normalize_0_1_batch - 1."""
    return 2.0 * normalize_0_1_batch(x) - 1.0


def resize_bilinear_antialias(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of an NCHW batch (kornia.resize(...,
    'bilinear', antialias=True) in the reference)."""
    return F.interpolate(x, size=size, mode="bilinear", antialias=True, align_corners=False)
