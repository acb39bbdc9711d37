"""Fused bias + leaky-ReLU + scale over the last (channel) axis.

``y = where(x + b >= 0, x + b, slope * (x + b)) * scale`` on an NHWC or
``[B, C]`` tensor, computed in f32 and stored in ``x``'s dtype; the bias is
always f32 (reference op_static/fused_bias_act_kernel.cu, LeakyReLU case).

Two versions of the same function live here:

* :func:`fused_leaky_relu_ref` - plain PyTorch.  CPU tensors use it (and
  autograd through it); it is the oracle the kernel is held against.
* a Triton kernel for CUDA tensors.  It replaces the TPU kernel
  ``multi_stylegan_tpu/ops/pallas_kernels.py::_flr_fwd_kernel`` (launched
  through ``_elementwise_call``'s ``pl.pallas_call``).  The pass is purely
  memory-bound on an H100: it reads ``x`` once and writes ``y`` once (4 f32
  operations per element against 8 bytes), so its bound is bytes over the
  card's 3.35 TB/s.  Its design follows: one masked ``[BLOCK_M, BLOCK_C]``
  tile per program over the ``[M, C]`` view, the bias row loaded once per
  tile, no data held across programs.  Unlike the TPU kernel it needs no
  row padding: the ragged edge is masked.

A CUDA tensor launches the kernel or raises; there is no fallback.  The
kernel is forward only: a CUDA call that needs a gradient raises until the
backward kernel (``_flr_grad_kernel``) is ported with the training path.
"""

from __future__ import annotations

import math

import torch

# Launches of the Triton kernel since import (or since a caller reset it).
launches = 0

# Bound to ``triton.language`` at the first launch, so that importing this
# module needs no triton (the kernel body reads ``tl`` as a global).
tl = None
_KERNEL = None


def fused_leaky_relu_ref(
    x: torch.Tensor,
    bias: torch.Tensor = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Plain PyTorch version: f32 math over the last axis, output in x.dtype."""
    y = x.float()
    if bias is not None:
        y = y + bias.float()
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu(
    x: torch.Tensor,
    bias: torch.Tensor = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Fused bias + leaky-ReLU + scale on the last axis of ``x``.

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel (contiguous channels-last input, f32 or bf16).
    """
    if x.device.type == "cpu":
        return fused_leaky_relu_ref(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu: unsupported device {x.device}")
    if torch.is_grad_enabled() and (
        x.requires_grad or (bias is not None and bias.requires_grad)
    ):
        raise NotImplementedError(
            "fused_leaky_relu on CUDA is forward-only: its backward kernel "
            "(_flr_grad_kernel) is ported with the training slice"
        )
    return _fused_leaky_relu_cuda(x, bias, float(negative_slope), float(scale))


def _kernel():
    """Build the Triton kernel at first use."""
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def flr_fwd(x_ptr, b_ptr, y_ptr, M, C, slope, scale,
                    BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
            rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
            cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            col_ok = cols < C
            mask = (rows[:, None] < M) & col_ok[None, :]
            # 64-bit offsets: M * C passes 2**31 at batch 64 and 256^2 x 512
            offs = rows[:, None].to(tl.int64) * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=col_ok, other=0.0)
            y = x + b[None, :]
            y = tl.where(y >= 0, y, y * slope) * scale
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

        _KERNEL = flr_fwd
    return _KERNEL


def _fused_leaky_relu_cuda(x, bias, negative_slope, scale):
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_leaky_relu: unsupported dtype {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"fused_leaky_relu: empty or 0-d input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(
            "fused_leaky_relu: the channel axis must be last and the tensor "
            "contiguous (pass NCHW activations as x.permute(0, 2, 3, 1) of a "
            "channels_last tensor)"
        )
    c = x.shape[-1]
    m = x.numel() // c
    if bias is None:
        bias = torch.zeros(c, dtype=torch.float32, device=x.device)
    if bias.shape != (c,) or bias.dtype != torch.float32 or bias.device != x.device:
        raise ValueError(
            f"fused_leaky_relu: bias must be f32 [{c}] on {x.device}, got "
            f"{bias.dtype} {tuple(bias.shape)} on {bias.device}"
        )
    bias = bias.contiguous()
    y = torch.empty_like(x)
    block_c = min(_next_pow2(c), 256)
    block_m = max(1, 4096 // block_c)
    grid = (-(-m // block_m), -(-c // block_c))
    with torch.cuda.device(x.device):
        _kernel()[grid](x, bias, y, m, c, negative_slope, scale,
                        BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4)
    launches += 1
    return y


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())
