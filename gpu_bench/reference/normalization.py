"""Normalization primitives on NCHW / [B, C] tensors.

PixelwiseNormalization: reference multi_stylegan/equalized_layer.py:257-277.
MinibatchStdDev: reference multi_stylegan/u_net_2d_discriminator.py:189-217.
"""

from __future__ import annotations

import torch

from gpu_bench.reference import single as mesh


def pixel_norm(x: torch.Tensor, eps: float = 1e-8, dim: int = -1) -> torch.Tensor:
    """x / sqrt(mean(x^2, channel) + eps) (equalized_layer.py:276)."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def minibatch_std_dev(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Append the scalar mean of the per-position batch std as one channel
    (u_net_2d_discriminator.py:205-217): std over the batch per (c, h, w),
    clamped at eps inside the sqrt, averaged to one scalar, broadcast and
    concatenated after the last channel of NCHW ``x``.

    Statistics in f32: under bf16, tiny variances quantize to the eps clamp
    where sqrt's second derivative explodes (R1's grad-of-grad).  Under data
    parallelism the batch is this call's global batch (parallel/mesh.py),
    whose rows may fall unevenly (a rank may hold none): the mean, then the
    mean of (x - mean)^2, each a differentiable sum over the ranks, so R1
    differentiates through both twice; the global row count rides in the
    first sum."""
    x32 = x.float()
    if mesh.world() == 1:
        var = (x32 - x32.mean(dim=0, keepdim=True)).square().mean(dim=0)
    else:
        first = mesh.all_sum(torch.cat([x32.sum(dim=0).reshape(-1),
                                        x32.new_tensor([float(x.shape[0])])]))
        n = first[-1].detach()
        mean = first[:-1].view(1, *x.shape[1:]) / n
        var = mesh.all_sum((x32 - mean).square().sum(dim=0)) / n
    stat = torch.sqrt(torch.clamp(var, min=eps)).mean().to(x.dtype)
    b, _, h, w = x.shape
    feat = stat.expand(b, 1, h, w)
    return torch.cat([x, feat], dim=1)
