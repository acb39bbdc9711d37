"""upfirdn2d on NHWC tensors: upsample (zero-stuff), FIR filter, downsample,
with its gradient and double gradient.

Reference semantics: multi_stylegan/op_static/upfirdn2d.py:148-191 and its
CUDA kernel; the output extent per spatial dim is
``(in * up + pad0 + pad1 - k) // down + 1`` (upfirdn2d_kernel.cu:167-168).
The taps are applied as a true convolution (flipped) and zero-stuffing
appends trailing zeros (``n * up`` samples, not ``(n - 1) * up + 1``).

Two versions of the same op live here:

* :func:`upfirdn2d_ref` - plain PyTorch (zero-stuff, pad or crop, depthwise
  ``F.conv2d`` with the flipped taps, stride ``down``).  CPU tensors use it;
  it is the oracle the kernel is held against.
* the CUDA C++ kernels ``csrc/upfirdn2d.cu`` for CUDA tensors (its header
  says what they replace, what bounds them and how), built at first use by
  ``ops/cuda_build.py`` and called through ``ctypes``.  :func:`_plan` picks
  one of its variants per launch: a tiled form for each of (up 1, down 1),
  (up 2, down 1) and (up 1, down 2) with 4x4 taps, C a multiple of the
  16-byte vector and 16-byte aligned tensors, else the general form; the C
  side refuses a variant the call does not allow.

Gradients mirror the reference's autograd pair ``UpFirDn2d`` /
``UpFirDn2dBackward`` (op_static/upfirdn2d.py:22-145), as the JAX package's
``_upfirdn_grad`` does (ops/pallas_kernels.py:328-379): the backward is the
same op on the cotangent with the taps flipped, ``up`` and ``down`` swapped
and the adjoint pads, and it is itself a Function whose backward is the
forward op again.  Both directions launch the same kernel (K3 forward, K4
backward, counted apart), so grad-of-grad for R1 and path length runs on
the card to any order.  A CUDA tensor launches the kernel or raises; there is
no fallback.  A batch of no rows (a data rank's empty share) gives the
empty result without a launch; any other empty extent raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from multi_stylegan_torch.ops import cuda_build

# Launches of the CUDA kernel since import (or since a caller reset them):
# ``launches`` for forward calls (K3), ``grad_launches`` for the adjoint
# launches of the backward (K4).
launches = 0
grad_launches = 0
# The variant the last launch took, a name from VARIANTS.
last_variant = None

# Variant codes of csrc/upfirdn2d.cu (enum Variant), by index.
VARIANTS = ("general", "up1-down1", "up2-down1", "up1-down2")
_TILED = {(1, 1): 1, (2, 1): 2, (1, 2): 3}

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # channels per 16-byte vector
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


def _upfirdn(x, kernel, up, down, pad, adjoint=False):
    """One launch of the op on normalized pads: the kernel on a CUDA tensor,
    the plain version on a CPU one."""
    if x.device.type == "cpu":
        return upfirdn2d_ref(x, kernel, up, down, (pad[2], pad[3], pad[0], pad[1]))
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d: unsupported device {x.device}")
    return _upfirdn2d_cuda(x, kernel, up, down, pad, adjoint)


def _adjoint_pads(kernel_hw, up, down, pad, in_hw, out_hw):
    """Pads of the gradient pass (reference UpFirDn2dBackward.forward,
    op_static/upfirdn2d.py:114-119), normalized (y0, y1, x0, x1)."""
    (kh, kw), (py0, _, px0, _), (ih, iw), (oh, ow) = kernel_hw, pad, in_hw, out_hw
    return (kh - py0 - 1, ih * up - oh * down + py0 - up + 1,
            kw - px0 - 1, iw * up - ow * down + px0 - up + 1)


class UpFirDn2d(torch.autograd.Function):
    """y = upfirdn2d(x); backward is :class:`UpFirDn2dBackward` (no tap grad:
    the taps are fixed buffers).  ``adjoint`` marks a launch made by a
    backward pass (the double backward), counted as K4."""

    @staticmethod
    def forward(ctx, x, kernel, up, down, pad, adjoint=False):
        y = _upfirdn(x, kernel, up, down, pad, adjoint)
        ctx.save_for_backward(kernel)
        ctx.consts = (up, down, pad, tuple(x.shape[1:3]), tuple(y.shape[1:3]))
        return y

    @staticmethod
    def backward(ctx, g):
        (kernel,) = ctx.saved_tensors
        gx = UpFirDn2dBackward.apply(g, kernel, *ctx.consts)
        return gx, None, None, None, None, None


class UpFirDn2dBackward(torch.autograd.Function):
    """The adjoint of upfirdn2d: flipped taps, up and down swapped, adjoint
    pads; its own backward is the forward op on the cotangent."""

    @staticmethod
    def forward(ctx, g, kernel, up, down, pad, in_hw, out_hw):
        gpad = _adjoint_pads(tuple(kernel.shape), up, down, pad, in_hw, out_hw)
        # a cotangent may arrive in any layout; the caller's forward input may not
        gx = _upfirdn(g.contiguous(), kernel.flip(0, 1).contiguous(), down, up, gpad,
                      adjoint=True)
        if tuple(gx.shape[1:3]) != tuple(in_hw):
            raise AssertionError(f"upfirdn2d adjoint gave {tuple(gx.shape)}, want {in_hw}")
        ctx.save_for_backward(kernel)
        ctx.consts = (up, down, pad)
        return gx

    @staticmethod
    def backward(ctx, gg):
        (kernel,) = ctx.saved_tensors
        up, down, pad = ctx.consts
        return (UpFirDn2d.apply(gg.contiguous(), kernel, up, down, pad, True),
                None, None, None, None, None, None)


def upfirdn2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: int = 1,
    down: int = 1,
    pad: Union[int, Sequence[int]] = (0, 0),
) -> torch.Tensor:
    """upfirdn2d on an NHWC tensor with [kh, kw] f32 taps, with autograd to
    any order in ``x``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (NHWC input - the ``permute(0, 2, 3, 1)`` view of a channels_last
    tensor - in f32 or bf16; contiguous f32 taps) forward and backward.
    """
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    if int(up) < 1 or int(down) < 1:
        raise ValueError(f"upfirdn2d: up and down must be >= 1, got {up}, {down}")
    return UpFirDn2d.apply(x, kernel.detach(), int(up), int(down), _normalize_pad(pad))


def _plan(shape, dtype, up, down, kh, kw, pad, ptrs) -> int:
    """The kernel variant (an index of VARIANTS) for one launch on an NHWC
    input of ``shape`` with normalized pads: a tiled form where (up, down)
    is one of its pairs, the taps are 4x4, C is a multiple of the 16-byte
    vector and every pointer in ``ptrs`` (input, output) is 16-byte aligned,
    within the grid's limits; else 0, the general form.  The C side checks
    the same conditions (``tiled_ok``) and refuses a mismatch."""
    b, h, w, c = shape
    variant = _TILED.get((up, down), 0)
    vec = _VEC.get(dtype)
    if not variant or vec is None or (kh, kw) != (4, 4) or c % vec:
        return 0
    if any(p % 16 for p in ptrs):
        return 0
    ho = out_size(h, up, down, pad[0], pad[1], kh)
    wo = out_size(w, up, down, pad[2], pad[3], kw)
    chunks = -(-c // (8 * vec))
    if b > 65535 or chunks * -(-ho // 8) * -(-wo // 16) > _INT_MAX:
        return 0
    return variant


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_build.build("upfirdn2d")))
        fn = lib.upfirdn2d_nhwc
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _upfirdn2d_cuda(x, kernel, up, down, pad, adjoint=False):
    global launches, grad_launches, last_variant
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
    if ho <= 0 or wo <= 0 or h == 0 or w == 0 or c == 0:
        raise ValueError(f"upfirdn2d: empty input or output {tuple(x.shape)} -> {b}x{ho}x{wo}x{c}")
    if wo * c > _INT_MAX or b * max(h, ho) > _INT_MAX or max(h, w) * up > _INT_MAX:
        raise ValueError(f"upfirdn2d: shape {tuple(x.shape)} exceeds the kernel's int range")
    y = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    if b == 0:  # no rows: nothing to compute, and a zero-size grid cannot launch
        return y
    variant = _plan(x.shape, x.dtype, up, down, kh, kw, pad, (x.data_ptr(), y.data_ptr()))
    with torch.cuda.device(x.device):
        rc = _library().upfirdn2d_nhwc(
            x.data_ptr(), kernel.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype], variant,
            b, h, w, c, ho, wo, kh, kw, up, down, py0, px0,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"upfirdn2d kernel ({VARIANTS[variant]}) launch failed: cudaError {rc}")
    last_variant = VARIANTS[variant]
    if adjoint:
        grad_launches += 1
    else:
        launches += 1
    return y
