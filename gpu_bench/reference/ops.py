"""The port's two custom ops in their plain forms, differentiated by autograd
to any order: fused bias + leaky ReLU + scale over the last axis, and
upfirdn2d on NHWC tensors (the port's ``fused_leaky_relu_ref`` and
``upfirdn2d_ref``)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor = None, negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """f32 math over the last axis, output in x's dtype."""
    y = x.float()
    if bias is not None:
        y = y + bias.float()
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def normalize_pad(pad: Union[int, Sequence[int]]) -> Tuple[int, int, int, int]:
    """(pad_y0, pad_y1, pad_x0, pad_x1) from an int, (pad0, pad1) or (x0, x1, y0, y1)."""
    if isinstance(pad, int):
        return (pad, pad, pad, pad)
    pad = tuple(int(p) for p in pad)
    if len(pad) == 2:
        return (pad[0], pad[1], pad[0], pad[1])
    if len(pad) == 4:
        return (pad[2], pad[3], pad[0], pad[1])
    raise ValueError(f"pad must have 1, 2 or 4 entries, got {pad}")


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: Union[int, Sequence[int]] = (0, 0)) -> torch.Tensor:
    """[B, H, W, C] -> [B, Ho, Wo, C]: zero-stuff by ``up``, pad (or crop),
    true convolution with the taps, stride ``down``; f32 inside.

    The filter is a sum of the padded input's shifted (strided) windows, one
    per tap, each times its tap: plain elementwise arithmetic, whose first
    and second derivatives are the same kind of sums (a depthwise
    convolution's double backward is orders slower on the card)."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    py0, py1, px0, px1 = normalize_pad(pad)
    b, h, w, c = x.shape
    kh, kw = kernel.shape
    t = x.float()
    if up > 1:
        z = t.new_zeros(b, h * up, w * up, c)
        z[:, ::up, ::up, :] = t
        t = z
    t = F.pad(t, (0, 0, px0, px1, py0, py1))  # negative entries crop
    ho, wo = (t.shape[1] - kh) // down + 1, (t.shape[2] - kw) // down + 1
    # the taps as host numbers (on the meta device, where only shapes are
    # counted, ones)
    taps = ([[1.0] * kw] * kh if kernel.is_meta
            else kernel.detach().float().flip(0, 1).cpu().tolist())
    y = None
    for i in range(kh):
        for j in range(kw):
            term = t[:, i:i + (ho - 1) * down + 1:down, j:j + (wo - 1) * down + 1:down, :]
            term = term * taps[i][j]
            y = term if y is None else y + term
    return y.to(x.dtype)
