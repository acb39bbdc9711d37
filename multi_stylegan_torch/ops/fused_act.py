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
  rows) and zero for ``out``: :class:`FusedLeakyReLUDoubleBackward`, one
  dx-only K2 with gg_db as its addend.  That is what R1 and path length
  differentiate through.

Each op has two versions: plain PyTorch (:func:`fused_leaky_relu_ref`,
:func:`fused_leaky_relu_grad_ref`), which CPU tensors use and the kernels are
held against, and a kernel for CUDA tensors.  A CUDA tensor launches the
kernel or raises; there is no fallback.  A tensor with no rows (a data
rank's empty share of a batch) gives the empty result, and K2 a zero bias
grad, without a launch: there is no work, and a zero-size grid cannot
launch.  Any other empty tensor raises.

* K1 replaces ``multi_stylegan_tpu/ops/pallas_kernels.py::_flr_fwd_kernel``.
  It reads ``x`` once and writes ``y`` once (4 f32 operations per element
  against 8 bytes): bound by bytes over the card's 3.35 TB/s.  A Triton
  kernel, one masked ``[BLOCK_M, BLOCK_C]`` tile per program over the
  ``[M, C]`` view.
* K2 replaces ``pallas_kernels.py::_flr_grad_kernel`` together with the bias
  sum of ``_flr_2d_bwd``: the CUDA C++ kernel ``csrc/fused_act.cu`` (its
  header says what bounds it and how), built by ``ops/cuda_build.py`` and
  called through ``ctypes``.  One launch computes dx and the bias grad: a
  persistent grid walks the rows with the column sums in registers, each
  block writes one f32 partial row, and the last block to finish adds the
  partial rows in a fixed order, so the bias grad is the same bits run to
  run.  :func:`_grad_plan` sizes the grid.  A dx-only form, with an optional
  f32 addend broadcast over the rows, serves the double backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from multi_stylegan_torch.ops import cuda_build

# Launches of each kernel since import (or since a caller reset them):
# ``launches`` for K1, ``grad_launches`` for K2 (one per call, either form),
# ``grad_dx_only_launches`` for the K2 calls of the dx-only form.
launches = 0
grad_launches = 0
grad_dx_only_launches = 0

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
    scale: float = math.sqrt(2.0), addend: torch.Tensor = None, need_db: bool = True,
):
    """Plain PyTorch gradient: (dx in g.dtype, f32 bias grad over the last
    axis, or None without ``need_db``).  An f32 ``addend`` [C] is rounded to
    g's dtype and added to g first (the sum rounded to g's dtype too)."""
    if addend is not None:
        g = g + addend.to(g.dtype)
    gf = g.float()
    dx = (torch.where(out >= 0, gf, gf * negative_slope) * scale).to(g.dtype)
    return dx, (dx.float().reshape(-1, dx.shape[-1]).sum(0) if need_db else None)


def _forward(x, bias, negative_slope, scale):
    """K1 on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return fused_leaky_relu_ref(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu: unsupported device {x.device}")
    return _fused_leaky_relu_cuda(x, bias, float(negative_slope), float(scale))


def _grad(g, out, negative_slope, scale, addend=None, need_db=True):
    """K2 on a CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return fused_leaky_relu_grad_ref(g, out, negative_slope, scale, addend, need_db)
    if g.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu grad: unsupported device {g.device}")
    return _fused_leaky_relu_grad_cuda(g, out, float(negative_slope), float(scale),
                                       addend, need_db)


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
        # a cotangent may arrive in NCHW order (the flagship D's 16x16x1024
        # map does, in R1): the kernel takes the forward output's layout
        dx, db = _grad(g.contiguous(), out, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.consts = (negative_slope, scale)
        return dx, db

    @staticmethod
    def backward(ctx, gg_dx, gg_db):
        (out,) = ctx.saved_tensors
        ggo = FusedLeakyReLUDoubleBackward.apply(gg_dx, gg_db, out, *ctx.consts)
        return ggo, None, None, None


class FusedLeakyReLUDoubleBackward(torch.autograd.Function):
    """K2's masked scale of ``gg_dx + gg_db`` (gg_db, f32 [C], broadcast over
    the rows): d(db)/dg broadcasts gg_db, and both terms share the mask, so
    one dx-only K2 with gg_db as its addend.  Its own backward is
    :class:`FusedLeakyReLUBackward` (dx for gg_dx, the bias sum for gg_db)."""

    @staticmethod
    def forward(ctx, gg_dx, gg_db, out, negative_slope, scale):
        # gg_dx may arrive in NCHW order (R1's double backward at four of the
        # flagship D's maps) and gg_db as an expanded view: copy each to the
        # layout the kernel takes
        ggo, _ = _grad(gg_dx.contiguous(), out, negative_slope, scale, gg_db.contiguous(),
                       need_db=False)
        ctx.save_for_backward(out)
        ctx.consts = (negative_slope, scale)
        return ggo

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        dx, db = FusedLeakyReLUBackward.apply(g, out, *ctx.consts)
        return dx, db, None, None, None


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
    """Build K1's Triton kernel at first use."""
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

        _KERNELS = flr_fwd
    return _KERNELS


def no_rows(t: torch.Tensor) -> bool:
    """Whether ``t`` is empty only for having no rows: its first dim 0 and
    every other dim, the channels among them, nonzero (a data rank's share
    of a batch that fell unevenly, parallel/mesh.py)."""
    return t.dim() >= 2 and t.shape[0] == 0 and all(n > 0 for n in t.shape[1:])


def _check_2d(name, t):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if t.dim() < 1 or (t.numel() == 0 and not no_rows(t)):
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
    if m == 0:  # no rows: nothing to compute, and a zero-size grid cannot launch
        return y
    block_c = min(_next_pow2(c), 256)
    block_m = max(1, 4096 // block_c)
    grid = (-(-m // block_m), -(-c // block_c))
    with torch.cuda.device(x.device):
        _kernels()[grid](x, bias, y, m, c, negative_slope, scale,
                            BLOCK_M=block_m, BLOCK_C=block_c, num_warps=4)
    launches += 1
    return y


# K2's launch geometry, the constants of csrc/fused_act.cu (kThreads,
# kLanes, kUnroll, kBlocksPerSm: the persistent grid's blocks a SM).
_THREADS = 256
_LANES = 32
_UNROLL = 4
_BLOCKS_PER_SM = 3
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte vector
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None
_SM_COUNT = {}  # device index -> multiprocessors
_SCRATCH = {}  # (device index, stream) -> (f32 partial rows, uint32 tickets)


class GradPlan(NamedTuple):
    """One K2 launch: the 16-byte vector form or the scalar one, the column
    threads a row (``lanes``), the grid (row blocks, column slices), the
    rows each row block walks, and the f32 partial rows of the bias sum (0
    when one row block writes db itself, or in the dx-only form),
    ``partial_rows * C`` floats of scratch."""

    vector: bool
    lanes: int
    grid: Tuple[int, int]
    rows_per_block: int
    partial_rows: int
    scratch_floats: int


@functools.lru_cache(maxsize=1024)
def _grad_plan(m: int, c: int, dtype: torch.dtype, aligned: bool, sm_count: int,
               need_db: bool) -> GradPlan:
    """K2's launch on an ``[m, c]`` view: the vector form where C is a
    multiple of the 16-byte vector and g, out and dx are 16-byte
    ``aligned``; column slices one warp wide (32 vectors, or 32 columns in
    the scalar form), or a power of two narrower where a row holds fewer
    vectors (a warp then spans several rows); ``_BLOCKS_PER_SM`` blocks a SM
    in all, never fewer than one row per thread and unrolled step
    (``_UNROLL * _THREADS / lanes`` rows) a block, each walking one
    contiguous run of rows.  The C side re-checks the plan."""
    vector = aligned and c % _VEC[dtype] == 0
    vec = _VEC[dtype] if vector else 1
    lanes = min(_LANES, 1 << (-(-c // vec) - 1).bit_length())
    slices = -(-c // (lanes * vec))
    if slices > 65535:
        raise ValueError(f"fused_leaky_relu grad: {c} channels exceed the kernel's grid")
    blocks = max(1, min(-(-_BLOCKS_PER_SM * sm_count // slices),
                        m // (_UNROLL * _THREADS // lanes)))
    rows = -(-m // blocks)
    blocks = -(-m // rows)
    partial_rows = blocks if need_db and blocks > 1 else 0
    return GradPlan(vector, lanes, (blocks, slices), rows, partial_rows, partial_rows * c)


# flr_grad's arguments: g, out, addend, dx, db, partials, tickets; M, C,
# slope, scale; dtype, vector, lanes, grid_x; rows_per_block, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                      ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_longlong, ctypes.c_void_p])


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_build.build("fused_act")))
        fn = lib.flr_grad
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = _SM_COUNT[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _scratch(device: torch.device, stream, floats: int, slices: int):
    """The stream's partial rows (at least ``floats``) and tickets (at least
    ``slices``, zero between launches: the last block resets its own).
    Cached per device and stream, grown on demand: launches on one stream
    run in order, so they may share them; two streams never do."""
    key = (device.index, stream.cuda_stream)
    partials, tickets = _SCRATCH.get(key, (None, None))
    if partials is None or partials.numel() < floats:
        partials = torch.empty(max(floats, 1 << 16), dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < slices:
        tickets = torch.zeros(max(slices, 64), dtype=torch.int32, device=device)
    _SCRATCH[key] = (partials, tickets)
    return partials, tickets


def _fused_leaky_relu_grad_cuda(g, out, negative_slope, scale, addend=None, need_db=True):
    global grad_launches, grad_dx_only_launches
    m, c = _check_2d("fused_leaky_relu grad", g)
    if (out.shape != g.shape or out.dtype != g.dtype or out.device != g.device
            or not out.is_contiguous()):
        raise ValueError(
            f"fused_leaky_relu grad: out must be a contiguous {g.dtype} {tuple(g.shape)} "
            f"tensor on {g.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if addend is not None and (addend.shape != (c,) or addend.dtype != torch.float32
                               or addend.device != g.device or not addend.is_contiguous()):
        raise ValueError(
            f"fused_leaky_relu grad: the addend must be a contiguous f32 [{c}] tensor on "
            f"{g.device}, got {addend.dtype} {tuple(addend.shape)} on {addend.device}")
    device = g.device
    dx = torch.empty_like(g)
    if m == 0:  # no rows: an empty dx, a zero bias sum, and no launch
        return dx, (torch.zeros((c,), dtype=torch.float32, device=device) if need_db else None)
    db = torch.empty((c,), dtype=torch.float32, device=device) if need_db else None
    aligned = (g.data_ptr() | out.data_ptr() | dx.data_ptr()) % 16 == 0
    plan = _grad_plan(m, c, g.dtype, aligned, _sm_count(device), bool(need_db))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        partials = tickets = None
        if plan.partial_rows:
            partials, tickets = _scratch(device, stream, plan.scratch_floats, plan.grid[1])
        rc = _library().flr_grad(
            g.data_ptr(), out.data_ptr(), None if addend is None else addend.data_ptr(),
            dx.data_ptr(), None if db is None else db.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            m, c, negative_slope, scale, _DTYPE_CODES[g.dtype], int(plan.vector), plan.lanes,
            plan.grid[0], plan.rows_per_block, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_leaky_relu grad kernel launch failed: cudaError {rc}")
    grad_launches += 1
    if not need_db:
        grad_dx_only_launches += 1
    return dx, db


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())
