"""Pixelwise normalization (reference multi_stylegan/equalized_layer.py:257-277)."""

from __future__ import annotations

import torch


def pixel_norm(x: torch.Tensor, eps: float = 1e-8, dim: int = -1) -> torch.Tensor:
    """x / sqrt(mean(x^2, channel) + eps) (equalized_layer.py:276)."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)
