"""Style-modulated convolution by input scaling: per-sample weights never exist.

StyleGAN2's modulated conv (reference multi_stylegan_generator.py:365-414)
builds a weight per sample and runs a grouped conv.  The same math as one
shared-weight conv (the JAX package's formulation, ops/modulated_conv.py):

    y_b = conv(x_b * s_b, scale * W) * d_b
    d_b[o] = rsqrt(sum_{i,k} (scale * W[o,i,k] * s_b[i])^2 + eps)
           = rsqrt(s_b^2 @ Q + eps),   Q[i, o] = scale^2 sum_k W[o,i,k]^2

with ``d`` computed in f32.  Activations are NCHW (channels_last memory
where the caller keeps them so); weights are OIHW ``[Cout, Cin, kh, kw]``,
the reference's ``[1, Cout, Cin, kh, kw]`` parameter without its leading 1.
The convolutions are PyTorch's, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _demod_factors(weight: torch.Tensor, style: torch.Tensor, scale: float,
                   eps: float) -> torch.Tensor:
    """[B, Cout] f32 demodulation factors from the squared styles."""
    q = (scale * scale) * weight.float().square().sum(dim=(2, 3)).t()  # [Cin, Cout]
    return torch.rsqrt(style.float().square() @ q + eps)


def modulated_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    *,
    scale: float,
    demodulate: bool = True,
    padding: int = 0,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Modulated (optionally demodulated) conv, stride 1.

    x [B, Cin, H, W], weight [Cout, Cin, kh, kw], style [B, Cin] (the output
    of the style affine); ``scale`` is the equalized-LR runtime scale
    sqrt(2)/sqrt(Cin*kh*kw) (multi_stylegan_generator.py:335).
    """
    xs = x * style[:, :, None, None].to(x.dtype)
    y = F.conv2d(xs, (weight * scale).to(x.dtype), padding=padding)
    if demodulate:
        y = y * _demod_factors(weight, style, scale, eps)[:, :, None, None].to(y.dtype)
    return y


def modulated_conv_transpose2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    *,
    scale: float,
    demodulate: bool = True,
    stride: int = 2,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Modulated transposed conv, padding 0 (multi_stylegan_generator.py:391-403).

    ``F.conv_transpose2d`` with the weight as ``[Cin, Cout, kh, kw]`` and no
    flip (rosinality's stylegan2-pytorch; NVlabs' flips it).  For
    Multi-StyleGAN's k2 s2 case the windows never overlap and this is
    exactly the JAX package's 1x1 product followed by depth-to-space; for
    StyleGAN2's k3 s2 (config F) neighbouring windows overlap by one row and
    column, which ``conv_transpose2d`` sums.  Demodulation is per output
    channel over the whole kernel either way.  Output extent =
    (H - 1) * stride + kh.
    """
    xs = x * style[:, :, None, None].to(x.dtype)
    w = (weight * scale).to(x.dtype).transpose(0, 1)
    y = F.conv_transpose2d(xs, w, stride=stride)
    if demodulate:
        y = y * _demod_factors(weight, style, scale, eps)[:, :, None, None].to(y.dtype)
    return y
