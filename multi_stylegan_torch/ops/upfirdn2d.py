"""upfirdn2d on NHWC tensors: upsample (zero-stuff), FIR filter, downsample.

Reference semantics: multi_stylegan/op_static/upfirdn2d.py:148-191 and its
CUDA kernel; the output extent per spatial dim is
``(in * up + pad0 + pad1 - k) // down + 1`` (upfirdn2d_kernel.cu:167-168).
The taps are applied as a true convolution (flipped) and zero-stuffing
appends trailing zeros (``n * up`` samples, not ``(n - 1) * up + 1``).

Two versions of the same function live here:

* :func:`upfirdn2d_ref` - plain PyTorch (zero-stuff, pad or crop, depthwise
  ``F.conv2d`` with the flipped taps, stride ``down``).  CPU tensors use it,
  with autograd; it is the oracle the kernel is held against.
* the CUDA C++ kernel ``csrc/upfirdn2d.cu`` for CUDA tensors (its header
  says what it replaces, what bounds it and how), built at first use by
  ``ops/cuda_build.py`` and called through ``ctypes``.

A CUDA tensor launches the kernel or raises; there is no fallback.  The
kernel is forward only: a CUDA call that needs a gradient raises until the
backward stencil is ported with the training path.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from multi_stylegan_torch.ops import cuda_build

# Launches of the CUDA kernel since import (or since a caller reset it).
launches = 0

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def _normalize_pad(pad: Union[int, Sequence[int]]) -> Tuple[int, int, int, int]:
    """Normalize pad to (pad_y0, pad_y1, pad_x0, pad_x1).

    A 2-tuple (pad0, pad1) applies to both spatial dims; a 4-tuple is
    (x0, x1, y0, y1), the order of the reference CUDA entry point.
    """
    if isinstance(pad, int):
        return (pad, pad, pad, pad)
    pad = tuple(int(p) for p in pad)
    if len(pad) == 2:
        return (pad[0], pad[1], pad[0], pad[1])
    if len(pad) == 4:
        return (pad[2], pad[3], pad[0], pad[1])
    raise ValueError(f"pad must have 1, 2 or 4 entries, got {pad}")


def out_size(in_size: int, up: int, down: int, pad0: int, pad1: int, k: int) -> int:
    """Output extent per spatial dim (upfirdn2d_kernel.cu:167-168)."""
    return (in_size * up + pad0 + pad1 - k) // down + 1


def upfirdn2d_ref(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: int = 1,
    down: int = 1,
    pad: Union[int, Sequence[int]] = (0, 0),
) -> torch.Tensor:
    """Plain PyTorch upfirdn2d: [B, H, W, C] -> [B, Ho, Wo, C], f32 inside."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    py0, py1, px0, px1 = _normalize_pad(pad)
    b, h, w, c = x.shape
    kh, kw = kernel.shape
    t = x.permute(0, 3, 1, 2).float()
    if up > 1:
        z = t.new_zeros(b, c, h * up, w * up)
        z[:, :, ::up, ::up] = t
        t = z
    t = F.pad(t, (px0, px1, py0, py1))  # negative entries crop
    taps = kernel.to(device=t.device, dtype=torch.float32).flip(0, 1)
    y = F.conv2d(t, taps[None, None].expand(c, 1, kh, kw), stride=down, groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upfirdn2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: int = 1,
    down: int = 1,
    pad: Union[int, Sequence[int]] = (0, 0),
) -> torch.Tensor:
    """upfirdn2d on an NHWC tensor with [kh, kw] f32 taps.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous NHWC input - the ``permute(0, 2, 3, 1)`` view of a
    channels_last tensor - in f32 or bf16; contiguous f32 taps).
    """
    if x.device.type == "cpu":
        return upfirdn2d_ref(x, kernel, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise NotImplementedError(
            "upfirdn2d on CUDA is forward-only: its backward stencil is "
            "ported with the training slice"
        )
    return _upfirdn2d_cuda(x, kernel, int(up), int(down), _normalize_pad(pad))


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_build.build("upfirdn2d")))
        fn = lib.upfirdn2d_nhwc
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _upfirdn2d_cuda(x, kernel, up, down, pad):
    global launches
    py0, py1, px0, px1 = pad
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"upfirdn2d: unsupported dtype {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            "upfirdn2d: expected a contiguous NHWC tensor (the "
            f"permute(0, 2, 3, 1) view of a channels_last one), got shape "
            f"{tuple(x.shape)} strides {x.stride()}"
        )
    if (kernel.dim() != 2 or kernel.dtype != torch.float32
            or kernel.device != x.device or not kernel.is_contiguous()):
        raise ValueError(
            f"upfirdn2d: taps must be a contiguous f32 [kh, kw] tensor on "
            f"{x.device}, got {kernel.dtype} {tuple(kernel.shape)} on {kernel.device}"
        )
    if up < 1 or down < 1:
        raise ValueError(f"upfirdn2d: up and down must be >= 1, got {up}, {down}")
    b, h, w, c = x.shape
    kh, kw = kernel.shape
    if kh * kw > 4096:
        raise ValueError(f"upfirdn2d: at most 4096 taps, got {kh}x{kw}")
    ho = out_size(h, up, down, py0, py1, kh)
    wo = out_size(w, up, down, px0, px1, kw)
    if ho <= 0 or wo <= 0 or b == 0 or c == 0:
        raise ValueError(f"upfirdn2d: empty output {b}x{ho}x{wo}x{c}")
    if wo * c > _INT_MAX or b * max(h, ho) > _INT_MAX or max(h, w) * up > _INT_MAX:
        raise ValueError(f"upfirdn2d: shape {tuple(x.shape)} exceeds the kernel's int range")
    y = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().upfirdn2d_nhwc(
            x.data_ptr(), kernel.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype],
            b, h, w, c, ho, wo, kh, kw, up, down, py0, px0,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"upfirdn2d kernel launch failed: cudaError {rc}")
    launches += 1
    return y
