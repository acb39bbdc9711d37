"""Equalized-learning-rate linear and conv layers (2-D, transposed 2-D and
1-D) and the bias-owning fused leaky-ReLU.

Reference: multi_stylegan/equalized_layer.py:9-74, 210-254 and
op_static/fused_act.py:76-85.  Weights are drawn ~N(0, 1) and scaled at run
time by sqrt(2)/sqrt(fan_in); the reference also scales the bias, by
sqrt(2)/sqrt(out_features), which is kept (so a style affine's "bias init
1.0" is an effective initial bias of sqrt(2/out)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multi_stylegan_torch.nn.layout import layout
from multi_stylegan_torch.ops.fused_act import fused_leaky_relu
from multi_stylegan_torch.parallel import tensor as tp


class EqualizedLinear(nn.Module):
    """y = x @ (W * sqrt(2/in)).T + b * sqrt(2/out), W stored [out, in]."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 bias_init: float = 0.0, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        if bias:
            self.bias = nn.Parameter(
                torch.full((out_features,), float(bias_init), device=device))
        else:
            self.register_parameter("bias", None)
        self.bias_init = float(bias_init)
        self.scale = math.sqrt(2.0) / math.sqrt(in_features)
        self.scale_bias = math.sqrt(2.0) / math.sqrt(out_features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator))
            if self.bias is not None:
                self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, (self.weight * self.scale).to(x.dtype))
        if self.bias is not None:
            y = y + (self.bias * self.scale_bias).to(x.dtype)
        return y


class EqualizedConv2d(nn.Module):
    """Equalized 2D conv on NCHW (channels_last) input, symmetric integer
    padding (equalized_layer.py:9-74): y = conv(x, W * sqrt(2/(Cin*k*k)))
    + b * sqrt(2/Cout), W stored [Cout, Cin, kh, kw], bias init 0.  Under
    tensor parallelism (parallel/tensor.py) the weight may hold this rank's
    output channels: the conv computes them and a gather makes the full
    output before the (replicated) bias."""

    tp_param = ("weight", 0)
    tp_sharded = False

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True, device=None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        else:
            self.register_parameter("bias", None)
        self.stride = stride
        self.padding = padding
        self.scale = math.sqrt(2.0) / math.sqrt(in_channels * k * k)
        self.scale_bias = math.sqrt(2.0) / math.sqrt(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.scale).to(x.dtype)
        if self.tp_sharded:
            y = tp.gather(F.conv2d(tp.copy(x), w, stride=self.stride, padding=self.padding))
        else:
            y = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        if self.bias is not None:
            y = y + (self.bias * self.scale_bias).to(x.dtype)[None, :, None, None]
        return y


class EqualizedTransposedConv2d(nn.Module):
    """Equalized 2D transposed conv on NCHW input (equalized_layer.py:77-143):
    ``conv_transpose2d`` with W * sqrt(2/(Cin*k*k)), W stored [Cin, Cout,
    kh, kw] as torch's transposed convs keep it, + b * sqrt(2/Cout) with the
    bias initialised to ONES (a reference quirk).  The models do not use it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 stride: int = 2, padding: int = 0, bias: bool = True, device=None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k, device=device))
        self.bias = (nn.Parameter(torch.ones(out_channels, device=device)) if bias else None)
        self.stride = stride
        self.padding = padding
        self.scale = math.sqrt(2.0) / math.sqrt(in_channels * k * k)
        self.scale_bias = math.sqrt(2.0) / math.sqrt(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, (self.weight * self.scale).to(x.dtype),
                               stride=self.stride, padding=self.padding)
        if self.bias is not None:
            y = y + (self.bias * self.scale_bias).to(x.dtype)[None, :, None, None]
        return y


class EqualizedConv1d(nn.Module):
    """Equalized 1D conv on [B, C, L] input (equalized_layer.py:146-207):
    W stored [Cout, Cin, k], bias initialised to ONES.  The models do not
    use it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               device=device))
        self.bias = (nn.Parameter(torch.ones(out_channels, device=device)) if bias else None)
        self.stride = stride
        self.padding = padding
        self.scale = math.sqrt(2.0) / math.sqrt(in_channels * kernel_size)
        self.scale_bias = math.sqrt(2.0) / math.sqrt(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x, (self.weight * self.scale).to(x.dtype), stride=self.stride,
                     padding=self.padding)
        if self.bias is not None:
            y = y + (self.bias * self.scale_bias).to(x.dtype)[None, :, None]
        return y


class FusedLeakyReLU(nn.Module):
    """Bias-owning fused leaky-ReLU on [B, C] or NCHW input.

    Module default scale is 1.0, not sqrt(2): the reference module default
    that every model use goes through (op_static/fused_act.py:77).  Runs on
    ``fused_leaky_relu``'s autograd Function (K1 forward, K2 backward).  An
    NCHW input goes to the kernel as its ``permute(0, 2, 3, 1)`` view: an
    NCHW-contiguous one as it is (K1's planar form) where the call's
    :func:`~multi_stylegan_torch.nn.layout.layout` is planar, anything else
    in channels_last memory (K2 takes only NHWC).
    """

    def __init__(self, channels: int, negative_slope: float = 0.2,
                 scale: float = 1.0, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:  # planar or channels_last: the kernel's view, no copy
            if not (layout(x.dtype) == "planar" and x.is_contiguous()):
                x = x.contiguous(memory_format=torch.channels_last)
            y = fused_leaky_relu(x.permute(0, 2, 3, 1), self.bias,
                                 self.negative_slope, self.scale)
            return y.permute(0, 3, 1, 2)
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
