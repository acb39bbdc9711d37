"""The memory layout of a model call's NCHW activations, one rule for every
module: planar (NCHW-contiguous) for f32 with autograd off, where cuDNN's
f32 convolutions are NCHW kernels, else ``torch.channels_last``, where the
bf16 convolutions are NHWC kernels and the gradient kernels (K2, K4) take
only NHWC.  Either way ``x.permute(0, 2, 3, 1)`` is the (B, H, W, C)-ordered
view that K1 and K3 take, told apart by its strides."""

from __future__ import annotations

import torch

FORMATS = {"planar": torch.contiguous_format, "channels_last": torch.channels_last}


def layout(dtype: torch.dtype) -> str:
    """The activations' layout of a call in ``dtype`` under the current
    autograd mode: ``"planar"`` for f32 with autograd off (``no_grad``,
    ``inference_mode``), else ``"channels_last"``."""
    return ("planar" if dtype == torch.float32 and not torch.is_grad_enabled()
            else "channels_last")
