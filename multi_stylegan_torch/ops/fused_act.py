"""Fused bias + leaky-ReLU + scale over the last (channel) axis, with its
gradient and double gradient.

``y = where(x + b >= 0, x + b, slope * (x + b)) * scale`` on an NHWC or
``[B, C]`` tensor, computed in f32 and stored in ``x``'s dtype; the bias is
always f32 (reference op_static/fused_bias_act_kernel.cu, LeakyReLU case).

The gradient takes its mask from the forward **output**, as the reference
CUDA grad does: ``dx = g * (out >= 0 ? 1 : slope) * scale`` stored in g's
dtype, and the bias grad is the f32 row sum of that stored ``dx``.  Two
``torch.autograd.Function``s mirror the JAX package's ``_flr_2d`` and
``_flr_grad_from_out`` (ops/pallas_kernels.py:115-157):

* :class:`FusedLeakyReLUFunction` runs the forward and saves its output;
  its backward is :class:`FusedLeakyReLUBackward` on (g, out).
* :class:`FusedLeakyReLUBackward` returns (dx, db); its own backward, given
  cotangents (gg_dx, gg_db), is the same masked scale applied to
  ``gg_dx + gg_db`` (the bias-sum's transpose broadcasts gg_db over the
  rows) and zero for ``out``.  That is what R1 and path length
  differentiate through.

Each op has two versions: plain PyTorch (:func:`fused_leaky_relu_ref`,
:func:`fused_leaky_relu_grad_ref`), which CPU tensors use and the kernels are
held against, and a Triton kernel for CUDA tensors.  A CUDA tensor launches
the kernel or raises; there is no fallback.

* K1 replaces ``multi_stylegan_tpu/ops/pallas_kernels.py::_flr_fwd_kernel``.
  It reads ``x`` once and writes ``y`` once (4 f32 operations per element
  against 8 bytes): bound by bytes over the card's 3.35 TB/s.  One masked
  ``[BLOCK_M, BLOCK_C]`` tile per program over the ``[M, C]`` view.
* K2 replaces ``pallas_kernels.py::_flr_grad_kernel`` together with the bias
  sum of ``_flr_2d_bwd``.  It reads g and out and writes dx (plus a small
  f32 partial-sum array): bound by bytes.  Each program walks ``ROW_ITERS``
  row tiles of one column block, stores dx and keeps an f32 column sum in
  registers, then writes one partial row; a second launch sums the partial
  rows per column in a fixed order.  No atomics, so the bias grad is the
  same bits run to run.
"""

from __future__ import annotations

import math

import torch

# Launches of each Triton kernel since import (or since a caller reset them).
# ``grad_launches`` counts one per K2 call (its column-sum pass included).
launches = 0
grad_launches = 0

# Bound to ``triton.language`` at the first launch, so that importing this
# module needs no triton (the kernel bodies read ``tl`` as a global).
tl = None
_KERNELS = None


def fused_leaky_relu_ref(
    x: torch.Tensor,
    bias: torch.Tensor = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Plain PyTorch forward: f32 math over the last axis, output in x.dtype."""
    y = x.float()
    if bias is not None:
        y = y + bias.float()
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu_grad_ref(
    g: torch.Tensor, out: torch.Tensor, negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
):
    """Plain PyTorch gradient: (dx in g.dtype, f32 bias grad over the last axis)."""
    gf = g.float()
    dx = (torch.where(out >= 0, gf, gf * negative_slope) * scale).to(g.dtype)
    return dx, dx.float().reshape(-1, dx.shape[-1]).sum(0)


def _forward(x, bias, negative_slope, scale):
    """K1 on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return fused_leaky_relu_ref(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu: unsupported device {x.device}")
    return _fused_leaky_relu_cuda(x, bias, float(negative_slope), float(scale))


def _grad(g, out, negative_slope, scale):
    """K2 on a CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return fused_leaky_relu_grad_ref(g, out, negative_slope, scale)
    if g.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu grad: unsupported device {g.device}")
    return _fused_leaky_relu_grad_cuda(g, out, float(negative_slope), float(scale))


class FusedLeakyReLUFunction(torch.autograd.Function):
    """y = K1(x, bias); saves y, whose sign is the gradient's mask."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        out = _forward(x, bias, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.consts = (negative_slope, scale, bias is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        negative_slope, scale, has_bias = ctx.consts
        dx, db = FusedLeakyReLUBackward.apply(g, out, negative_slope, scale)
        return dx, (db if has_bias else None), None, None


class FusedLeakyReLUBackward(torch.autograd.Function):
    """(dx, db) = K2(g, out); differentiable again in g (not in out)."""

    @staticmethod
    def forward(ctx, g, out, negative_slope, scale):
        dx, db = _grad(g, out, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.consts = (negative_slope, scale)
        return dx, db

    @staticmethod
    def backward(ctx, gg_dx, gg_db):
        (out,) = ctx.saved_tensors
        negative_slope, scale = ctx.consts
        # d(db)/dg broadcasts gg_db over the rows, and both terms share the
        # masked scale: one K2 on their sum (its bias sum is not needed).
        ggo, _ = FusedLeakyReLUBackward.apply(gg_dx + gg_db.to(gg_dx.dtype), out,
                                              negative_slope, scale)
        return ggo, None, None, None


def fused_leaky_relu(
    x: torch.Tensor,
    bias: torch.Tensor = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Fused bias + leaky-ReLU + scale on the last axis of ``x``, with
    autograd to any order.

    CPU tensors take the plain versions; CUDA tensors launch K1 forward and
    K2 backward (contiguous channels-last input, f32 or bf16; f32 bias).
    """
    return FusedLeakyReLUFunction.apply(x, bias, float(negative_slope), float(scale))


def _kernels():
    """Build the Triton kernels at first use."""
    global _KERNELS, tl
    if _KERNELS is None:
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

        @triton.jit
        def flr_grad(g_ptr, o_ptr, dx_ptr, part_ptr, M, C, slope, scale,
                     BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr,
                     ROW_ITERS: tl.constexpr):
            pid_m = tl.program_id(0)
            cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            col_ok = cols < C
            acc = tl.zeros([BLOCK_C], dtype=tl.float32)
            for it in range(ROW_ITERS):
                rows = (pid_m * ROW_ITERS + it) * BLOCK_M + tl.arange(0, BLOCK_M)
                mask = (rows[:, None] < M) & col_ok[None, :]
                offs = rows[:, None].to(tl.int64) * C + cols[None, :]
                g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                o = tl.load(o_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                dx = (tl.where(o >= 0, g, g * slope) * scale).to(dx_ptr.dtype.element_ty)
                tl.store(dx_ptr + offs, dx, mask=mask)
                # the bias grad sums the stored dx (masked entries are 0)
                acc += tl.sum(dx.to(tl.float32), axis=0)
            tl.store(part_ptr + pid_m.to(tl.int64) * C + cols, acc, mask=col_ok)

        @triton.jit
        def col_sum(part_ptr, out_ptr, R, C, BLOCK_R: tl.constexpr,
                    BLOCK_C: tl.constexpr):
            cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
            col_ok = cols < C
            acc = tl.zeros([BLOCK_C], dtype=tl.float32)
            for r0 in range(0, R, BLOCK_R):
                rows = r0 + tl.arange(0, BLOCK_R)
                mask = (rows[:, None] < R) & col_ok[None, :]
                p = tl.load(part_ptr + rows[:, None].to(tl.int64) * C + cols[None, :],
                            mask=mask, other=0.0)
                acc += tl.sum(p, axis=0)
            tl.store(out_ptr + cols, acc, mask=col_ok)

        _KERNELS = (flr_fwd, flr_grad, col_sum)
    return _KERNELS


def _check_2d(name, t):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if t.dim() < 1 or t.numel() == 0:
        raise ValueError(f"{name}: empty or 0-d input {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(
            f"{name}: the channel axis must be last and the tensor contiguous "
            "(pass NCHW activations as x.permute(0, 2, 3, 1) of a channels_last "
            "tensor)"
        )
    c = t.shape[-1]
    return t.numel() // c, c


def _fused_leaky_relu_cuda(x, bias, negative_slope, scale):
    global launches
    m, c = _check_2d("fused_leaky_relu", x)
    if bias is None:
        bias = torch.zeros(c, dtype=torch.float32, device=x.device)
    if bias.shape != (c,) or bias.dtype != torch.float32 or bias.device != x.device:
        raise ValueError(
            f"fused_leaky_relu: bias must be f32 [{c}] on {x.device}, got "
            f"{bias.dtype} {tuple(bias.shape)} on {bias.device}"
        )
    bias = bias.detach().contiguous()
    y = torch.empty_like(x)
    block_c = min(_next_pow2(c), 256)
    block_m = max(1, 4096 // block_c)
    grid = (-(-m // block_m), -(-c // block_c))
    with torch.cuda.device(x.device):
        _kernels()[0][grid](x, bias, y, m, c, negative_slope, scale,
                            BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4)
    launches += 1
    return y


def _fused_leaky_relu_grad_cuda(g, out, negative_slope, scale):
    global grad_launches
    g = g.contiguous()
    m, c = _check_2d("fused_leaky_relu grad", g)
    if out.shape != g.shape or out.device != g.device or not out.is_contiguous():
        raise ValueError(
            f"fused_leaky_relu grad: out must be a contiguous {tuple(g.shape)} "
            f"tensor on {g.device}, got {tuple(out.shape)} on {out.device}")
    _check_2d("fused_leaky_relu grad (out)", out)
    dx = torch.empty_like(g)
    block_c = min(_next_pow2(c), 256)
    block_m = max(1, 4096 // block_c)
    # up to 8 row tiles per program, so the partial sums stay a few MB at the
    # big sites, but never fewer than ~1k row programs: a small M walked 8
    # tiles deep leaves most SMs idle (24x16x16x1024 ran 4x its plain version)
    row_iters = max(1, min(8, -(-m // block_m) // 1024))
    n_prog_m = -(-m // (block_m * row_iters))
    partials = torch.empty((n_prog_m, c), dtype=torch.float32, device=g.device)
    db = torch.empty((c,), dtype=torch.float32, device=g.device)
    flr_grad, col_sum = _kernels()[1:]
    with torch.cuda.device(g.device):
        flr_grad[(n_prog_m, -(-c // block_c))](
            g, out, dx, partials, m, c, negative_slope, scale,
            BLOCK_M=block_m, BLOCK_C=block_c, ROW_ITERS=row_iters, num_warps=4)
        sum_c = min(_next_pow2(c), 128)
        col_sum[(-(-c // sum_c),)](partials, db, n_prog_m, c,
                                   BLOCK_R=32, BLOCK_C=sum_c, num_warps=4)
    grad_launches += 1
    return dx, db


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())
