"""Data-space augmentation: the elastic deformation (the JAX package's
data/transforms.py; reference dataset/tlfm_dataset.py:201-275).

A random displacement field, U(-1, 1) per pixel and axis, smoothed by an
unnormalised gaussian of kernel size 4 sigma + 1 (as the reference), scaled
by alpha, then a bilinear resample with the sample points clamped to the
border.  The training CLIs do not use it, as in the JAX package.  The field
is drawn from the caller's ``torch.Generator`` or handed in whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def gaussian_kernel(sigma: int, device=None) -> torch.Tensor:
    """[4 sigma + 1, 4 sigma + 1] unnormalised gaussian (tlfm_dataset.py:229-244)."""
    size = sigma * 4 + 1
    mean = (size - 1) / 2.0
    coords = torch.arange(size, dtype=torch.float32, device=device)
    sq = (coords[None, :] - mean) ** 2 + (coords[:, None] - mean) ** 2
    return (1.0 / (2.0 * math.pi * sigma ** 2)) * torch.exp(-sq / (2.0 * sigma ** 2))


def elastic_deformation(img: torch.Tensor, alpha: int = 50, sigma: int = 12, *,
                        generator: Optional[torch.Generator] = None,
                        displacement: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elastically deform [..., H, W] images (every leading plane by the same
    field).  ``displacement`` is the raw [2, 1, H, W] U(-1, 1) field (x then
    y), drawn from ``generator`` when not given."""
    h, w = img.shape[-2:]
    if displacement is None:
        displacement = torch.rand((2, 1, h, w), generator=generator,
                                  device=img.device) * 2.0 - 1.0
    k = gaussian_kernel(sigma, img.device)
    d = F.conv2d(displacement.to(img.device, torch.float32), k[None, None],
                 padding=k.shape[0] // 2) * alpha
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    sx = torch.clamp(xs + d[0, 0], 0, w - 1)
    sy = torch.clamp(ys + d[1, 0], 0, h - 1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    tx, ty = sx - x0, sy - y0
    flat = img.reshape(-1, h, w)

    def at(yi, xi):
        yi = torch.clamp(yi, 0, h - 1).long()
        xi = torch.clamp(xi, 0, w - 1).long()
        return flat[:, yi, xi]

    out = (at(y0, x0) * (1 - tx) * (1 - ty) + at(y0, x0 + 1) * tx * (1 - ty)
           + at(y0 + 1, x0) * (1 - tx) * ty + at(y0 + 1, x0 + 1) * tx * ty)
    return out.reshape(img.shape)


class ElasticDeformation:
    """The reference's module form (tlfm_dataset.py:201-227)."""

    def __init__(self, alpha: int = 80, sigma: int = 16) -> None:
        self.alpha = alpha
        self.sigma = sigma

    def __call__(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                 displacement: Optional[torch.Tensor] = None) -> torch.Tensor:
        return elastic_deformation(img, self.alpha, self.sigma, generator=generator,
                                   displacement=displacement)
