"""The controls that ``correct`` must fail: the reference computed one
precision below the configuration's.  bf16 goes to fp8 (e4m3, one scale a
tensor, the operands of every convolution and matmul rounded in the
forward, the backward left in bf16); f32 with TF32 off goes to TF32."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn
_OPS = [(F, "conv2d"), (F, "conv_transpose2d"), (F, "linear"), (torch, "bmm"), (torch, "matmul")]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at one scale for the tensor, back in its dtype;
    the gradient passes straight through (the backward stays in x's dtype)."""
    with torch.no_grad():
        scale = x.abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()


@contextlib.contextmanager
def fp8_operands():
    """Every floating operand of a convolution or matmul rounded to fp8 while
    entered (the functions themselves are swapped, so that a block that
    remat recomputes in the backward is rounded alike)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in _OPS]

    def rounded(fn):
        def call(*args, **kwargs):
            return fn(*(fp8(a) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                        for a in args), **kwargs)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, rounded(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def tf32():
    prior = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prior
