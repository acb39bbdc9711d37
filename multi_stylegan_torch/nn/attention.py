"""SAGAN-style non-local (self-attention) block on NCHW (channels_last) input.

Reference: multi_stylegan/u_net_2d_discriminator.py:335-381, as the JAX
package's nn/attention.py has it: theta/phi/g are 1x1 equalized convs; phi
and g are 2x max-pooled; softmax attention over the pooled positions with
logits NOT scaled by 1/sqrt(d); a learnable ``gamma`` (init 0) gates the
attention path; the residual sum is divided by sqrt(2).

R1 differentiates through this block twice, so every piece is plain
autograd that differentiates to any order: matmul + softmax (a fused
attention call's backward is first-order only), and a max-pool whose
backward is linear (see :func:`max_pool_2x`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multi_stylegan_torch.nn.equalized import EqualizedConv2d


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x max pooling as an argmax + one-hot masked sum (attention.py:24-46).

    Same values as a max-pool, the first maximum of each window (in
    (dy, dx) row-major order) wins ties, and the backward is a broadcast
    multiply by the constant mask: linear, so grad-of-grad is clean."""
    b, c, h, w = x.shape
    pw = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    pw = pw.reshape(b, c, h // 2, w // 2, 4)
    mask = F.one_hot(pw.detach().argmax(dim=-1), 4).to(pw.dtype)
    return (pw * mask).sum(dim=-1)


class NonLocalBlock(nn.Module):
    """``theta``, ``phi``, ``g``, ``o``, ``residual_mapping`` (when the
    channels change) and ``gamma``, as the reference's state dict names them."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        co = out_channels
        self.gamma = nn.Parameter(torch.zeros((), device=device))
        self.theta = EqualizedConv2d(in_channels, co // 8, 1, 1, 0, bias=False, device=device)
        self.phi = EqualizedConv2d(in_channels, co // 8, 1, 1, 0, bias=False, device=device)
        self.g = EqualizedConv2d(in_channels, co // 2, 1, 1, 0, bias=False, device=device)
        self.o = EqualizedConv2d(co // 2, co, 1, 1, 0, bias=False, device=device)
        if in_channels != co:
            self.residual_mapping = EqualizedConv2d(
                in_channels, co, 1, 1, 0, bias=False, device=device)
        else:
            self.residual_mapping = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)             # [B, HW, C/8]
        phi = max_pool_2x(self.phi(x)).flatten(2)                    # [B, C/8, HW/4]
        g = max_pool_2x(self.g(x)).flatten(2).transpose(1, 2)        # [B, HW/4, C/2]
        logits = torch.bmm(theta.float(), phi.float())               # [B, HW, HW/4]
        beta = torch.softmax(logits, dim=-1).to(x.dtype)
        attended = torch.bmm(beta.float(), g.float()).to(x.dtype)    # [B, HW, C/2]
        attended = attended.transpose(1, 2).reshape(b, attended.shape[-1], h, w)
        attended = attended.contiguous(memory_format=torch.channels_last)
        o = self.o(attended)
        res = x if self.residual_mapping is None else self.residual_mapping(x)
        return (self.gamma.to(x.dtype) * o + res) / math.sqrt(2.0)
