"""Blur / resampling helpers built on upfirdn2d (NHWC tensors).

Kernel construction and padding arithmetic of the reference ``Blur`` /
``Upsample`` modules (multi_stylegan_generator.py:529-641).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from multi_stylegan_torch.ops.upfirdn2d import upfirdn2d


def make_blur_kernel(
    taps: Sequence[int] = (1, 3, 3, 1), gain: float = 1.0, device=None
) -> torch.Tensor:
    """Outer-product, sum-normalized [k, k] f32 FIR kernel, times ``gain``
    (the ``sampling_factor ** 2`` of the post-upsample blur,
    multi_stylegan_generator.py:600-602)."""
    k = torch.as_tensor(taps, dtype=torch.float32, device=device)
    if k.dim() == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum() * gain


class Blur(nn.Module):
    """Holds an FIR kernel as the reference's ``kernel`` buffer (the
    ``Blur`` / ``Upsample`` modules' state)."""

    def __init__(self, taps: Sequence[int] = (1, 3, 3, 1), gain: float = 1.0, device=None):
        super().__init__()
        self.register_buffer("kernel", make_blur_kernel(taps, gain, device=device))


def blur_padding(
    n_taps: int, sampling_factor_padding: int = 2, kernel_size: int = 3
) -> Tuple[int, int]:
    """Padding used by ``Blur`` (multi_stylegan_generator.py:606-617)."""
    padding_factor = (n_taps - sampling_factor_padding) + (kernel_size - 1)
    return ((padding_factor + 1) // 2, padding_factor // 2)


def upsample_padding(n_taps: int, factor: int = 2) -> Tuple[int, int]:
    """Padding used by ``Upsample`` (multi_stylegan_generator.py:548-551)."""
    padding_factor = n_taps - factor
    return (((padding_factor + 1) // 2) + factor - 1, padding_factor // 2)


def blur(x: torch.Tensor, kernel: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
    """FIR blur of an NHWC tensor (no resampling)."""
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)


def upsample2x(
    x: torch.Tensor, taps: Sequence[int] = (1, 3, 3, 1), kernel: torch.Tensor = None
) -> torch.Tensor:
    """2x blur-upsample of an NHWC tensor (``Upsample.forward``,
    multi_stylegan_generator.py:568-575): the plain normalized kernel, with
    no factor**2 gain, as the reference's ``Upsample`` has it."""
    if kernel is None:
        kernel = make_blur_kernel(taps, device=x.device)
    pad = upsample_padding(kernel.shape[0], factor=2)
    return upfirdn2d(x, kernel, up=2, down=1, pad=pad)
