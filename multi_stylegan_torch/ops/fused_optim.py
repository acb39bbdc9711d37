"""The optimizer updates of the training iteration, over all of a model's
leaves at once: the clipped Adam step behind ``train/state.py::ClippedAdam``
and the EMA update behind ``train/ema.py``.

Both take tensors (the leaves, their gradients, the counters) and scalars;
the optimizer object and its groups stay in the train layer.  Each has two
versions.  The plain PyTorch loops over the leaves (:func:`clipped_adam_ref`,
:func:`ema_update_ref`) are what CPU tensors use and what the kernels are
held against.  CUDA tensors launch the multi-tensor kernels of
``csrc/fused_optim.cu`` (its header says what bounds them and how), built by
``ops/cuda_build.py`` and called through ``ctypes``; a CUDA tensor launches
them or raises, with no fallback.  An Adam step is two launches over up to
:data:`MAX_LEAVES` leaves (G has 164 at the paper's widths, D 64), an EMA
update one launch.

Both versions update the parameters, the moments and the counters in place,
so the tensors keep their identity.  The kernels' tables of pointers
(:class:`AdamTables`, :func:`_ema_tables`) are built once per set of tensors
and built anew when a pointer, a learning rate or a shard flag changes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multi_stylegan_torch.ops import cuda_build

# Kernel launches since import (or since a caller reset them): two an Adam
# step, and a copy for a gradient in a layout the kernels do not read
# (``adam_launches``); one an EMA update (``ema_launches``).
adam_launches = 0
ema_launches = 0

# csrc/fused_optim.cu's kChunk (values a block) and kMaxLeaves (gradient
# pointers a launch carries as kernel arguments).
CHUNK = 1 << 15
MAX_LEAVES = 320

# The device tables' rows, csrc/fused_optim.cu's AdamLeaf and EmaLeaf.
ADAM_LEAF = np.dtype([("p", "<u8"), ("m", "<u8"), ("v", "<u8"), ("n", "<i8"),
                      ("neg_lr", "<f4"), ("sharded", "<i4"), ("inner", "<i4"), ("taps", "<i4")])
EMA_LEAF = np.dtype([("e", "<u8"), ("p", "<u8"), ("n", "<i8")])

# The memory orders the kernels read a gradient in: the leaf seen as
# [O, I, K] (a 4-d one [O, I, H, W] with K = H * W, a 2-d one with K = 1),
# its axes (0 O, 1 I, 2 K) outer to inner.  0 is the leaf's own; cuDNN gives
# a conv weight's gradient as 1 (channels-last) or, in a double backward, as
# 2 (input channels outermost).  csrc/fused_optim.cu's order codes are the
# indices; any other layout is copied.
ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2))

_LIB = None


class AdamHyper(NamedTuple):
    """The step's scalars: Adam's betas and eps, the global-norm clip, and
    the non-finite skip (``skip_nonfinite``) with its forced apply after
    ``max_consecutive_nonfinite`` skips in a row."""

    b1: float
    b2: float
    eps: float
    max_norm: float
    skip_nonfinite: bool
    max_consecutive_nonfinite: int


# ------------------------------------------------------------------ plain


@torch.no_grad()
def clipped_adam_ref(params: Sequence[torch.Tensor], exp_avg: Sequence[torch.Tensor],
                     exp_avg_sq: Sequence[torch.Tensor],
                     grads: Sequence[Optional[torch.Tensor]], count: torch.Tensor,
                     notfinite_count: torch.Tensor, lrs: Sequence[float],
                     sharded: Sequence[bool], hyper: AdamHyper,
                     model_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                     ) -> torch.Tensor:
    """One step from ``grads`` (None = zero), the plain loop: each leaf at
    its ``lrs`` entry; a ``sharded`` leaf's sum of squares and the
    non-finite flag go through ``model_sum`` (None: this rank alone).
    Returns the device flag of whether the step applied."""
    grads = [torch.zeros_like(p) if g is None else g.detach() for p, g in zip(params, grads)]
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    squares = [g.float().square().sum() for g in grads]
    if any(sharded):
        rep = sum(q for q, s in zip(squares, sharded) if not s)
        blocks = torch.stack([sum(q for q, s in zip(squares, sharded) if s),
                              (~finite).float()])
        blocks = model_sum(blocks) if model_sum is not None else blocks
        g_norm = torch.sqrt(rep + blocks[0])
        finite = blocks[1] == 0
    else:
        g_norm = torch.sqrt(sum(squares))
    if hyper.skip_nonfinite:
        notfinite_count.copy_(torch.where(
            finite, torch.zeros_like(notfinite_count), notfinite_count + 1))
        apply = finite | (notfinite_count > hyper.max_consecutive_nonfinite)
    else:
        apply = torch.ones((), dtype=torch.bool, device=finite.device)
    clip = g_norm >= hyper.max_norm
    new_count = torch.where(apply, count + 1, count)
    bc1 = 1.0 - hyper.b1 ** new_count.float()
    bc2 = 1.0 - hyper.b2 ** new_count.float()
    for p, g, m, v, lr in zip(params, grads, exp_avg, exp_avg_sq, lrs):
        g = torch.where(clip, g / g_norm * hyper.max_norm, g)
        mu = (1.0 - hyper.b1) * g + hyper.b1 * m
        nu = (1.0 - hyper.b2) * g.square() + hyper.b2 * v
        update = -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + hyper.eps))
        p.copy_(torch.where(apply, p + update, p))
        m.copy_(torch.where(apply, mu, m))
        v.copy_(torch.where(apply, nu, v))
    count.copy_(new_count)
    return apply


@torch.no_grad()
def ema_update_ref(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                   decay: float) -> None:
    """e <- decay * e + (1 - decay) * p for each pair, the plain loop."""
    for e, p in zip(ema_params, params):
        e.mul_(decay).add_(p.detach().to(e.dtype) * (1.0 - decay))


# --------------------------------------------------------------- dispatch


def clipped_adam(params: Sequence[torch.Tensor], exp_avg: Sequence[torch.Tensor],
                 exp_avg_sq: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                 count: torch.Tensor, notfinite_count: torch.Tensor, lrs: Sequence[float],
                 sharded: Sequence[bool], hyper: AdamHyper,
                 model_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 tables: Optional["AdamTables"] = None
                 ) -> Tuple[torch.Tensor, Optional["AdamTables"]]:
    """One step (the arguments of :func:`clipped_adam_ref`): the kernels on
    the card, the plain loop on the CPU.  ``tables`` are the kernels' tables
    of an earlier call, used again where they still describe these leaves.
    Returns the applied flag and the tables to pass next time (None on the
    CPU)."""
    device = params[0].device
    if device.type == "cpu":
        return clipped_adam_ref(params, exp_avg, exp_avg_sq, grads, count, notfinite_count,
                                lrs, sharded, hyper, model_sum), None
    if device.type != "cuda":
        raise ValueError(f"clipped Adam: unsupported device {device}")
    key = AdamTables.key_of(params, exp_avg, exp_avg_sq, lrs, sharded)
    if tables is None or tables.key != key:
        tables = AdamTables(params, exp_avg, exp_avg_sq, lrs, sharded)
    return tables.step(grads, count, notfinite_count, hyper, model_sum), tables


def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float) -> None:
    """The EMA update over every pair: one launch on the card, the plain
    loop on the CPU."""
    device = ema_params[0].device
    if device.type == "cpu":
        return ema_update_ref(ema_params, params, decay)
    if device.type != "cuda":
        raise ValueError(f"EMA update: unsupported device {device}")
    _ema_update_cuda(ema_params, params, decay)


# --------------------------------------------------------------- planning


def plan_chunks(numels: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """The blocks of a multi-tensor launch: [n, 2] int32 (leaf, chunk index
    within the leaf), in leaf order; a chunk is ``chunk`` values, the leaf's
    last one what remains.  An empty leaf has no chunk; no values at all
    raises."""
    leaf_of: List[int] = []
    index: List[int] = []
    for leaf, n in enumerate(numels):
        k = -(-int(n) // chunk)
        leaf_of += [leaf] * k
        index += range(k)
    if not leaf_of:
        raise ValueError("fused optimizer: no values to update")
    if len(leaf_of) > 2**31 - 1:
        raise ValueError(f"fused optimizer: {len(leaf_of)} chunks exceed the grid")
    return np.ascontiguousarray(
        np.stack([np.asarray(leaf_of, np.int32), np.asarray(index, np.int32)], axis=1))


def three_axes(shape: Tuple[int, ...]) -> Optional[Tuple[int, int, int]]:
    """A leaf's [O, I, K] (4-d: K = H * W; 2-d: K = 1); None for the others,
    whose gradients the kernels read only in the leaf's own order."""
    if len(shape) == 4:
        return shape[0], shape[1], shape[2] * shape[3]
    if len(shape) == 2:
        return shape[0], shape[1], 1
    return None


@functools.lru_cache(maxsize=1024)
def grad_order(shape: Tuple[int, ...], strides: Tuple[int, ...]) -> Optional[int]:
    """The index in :data:`ORDERS` of a gradient's memory order (dense, the
    leaf seen as [O, I, K]), or None where it is none of them (or the leaf
    too large for the gather's 32-bit index): the wrapper then copies it."""
    axes = three_axes(shape)
    if axes is None or math.prod(shape) >= 2**31:
        return None
    if len(shape) == 4:
        (kh, kw), (sh, sw) = shape[2:], strides[2:]
        if kh > 1 and kw > 1 and sh != kw * sw:
            return None  # H and W do not merge into one axis
        got = (strides[0], strides[1], sw if kw > 1 else sh)
    else:
        got = (strides[0], strides[1], 1)
    for code, order in enumerate(ORDERS):
        want, size = [0, 0, 0], 1
        for axis in reversed(order):
            want[axis] = size
            size *= axes[axis]
        if all(axes[a] == 1 or got[a] == want[a] for a in range(3)):
            return code
    return None


# ------------------------------------------------------------------- CUDA


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_build.build("fused_optim")))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adam_reduce.argtypes = [p, p, i, p, p, i, p, p, p, p]
        lib.adam_update.argtypes = [p, p, i, p, p, i, p, p, p, p, p, p] + [f] * 6 + [i, i, p]
        lib.ema_update.argtypes = [p, p, i, f, f, p]
        for fn in (lib.adam_reduce, lib.adam_update, lib.ema_update):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _upload(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host table's bytes on the device, through pinned memory (no drain
    of the queue)."""
    host = torch.from_numpy(np.ascontiguousarray(rows).view(np.uint8).reshape(-1).copy())
    return host.pin_memory().to(device, non_blocking=True)


def _check_leaves(what: str, tensors: Sequence[torch.Tensor], device: torch.device,
                  numels: Optional[Sequence[int]] = None) -> None:
    if numels is not None and len(tensors) != len(numels):
        raise ValueError(f"fused optimizer: {len(tensors)} {what}s for {len(numels)} leaves")
    for i, t in enumerate(tensors):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device or (
                numels is not None and t.numel() != numels[i]):
            raise ValueError(
                f"fused optimizer: {what} {i} must be a contiguous f32 tensor on {device}"
                + ("" if numels is None else f" of {numels[i]} values")
                + f", got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def _pointers(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


class AdamTables:
    """The device tables of a set of leaves (their parameter and moment
    pointers, sizes, learning rates and shard flags; the chunks) and the
    scratch of their steps (the chunks' partial sums, two tickets, the
    totals); :attr:`key` says which leaves, rates and flags they hold."""

    @staticmethod
    def key_of(params, exp_avg, exp_avg_sq, lrs, sharded) -> tuple:
        return (_pointers(params), _pointers(exp_avg), _pointers(exp_avg_sq),
                tuple(float(lr) for lr in lrs), tuple(bool(s) for s in sharded))

    def __init__(self, params: Sequence[torch.Tensor], exp_avg: Sequence[torch.Tensor],
                 exp_avg_sq: Sequence[torch.Tensor], lrs: Sequence[float],
                 sharded: Sequence[bool]):
        self.device = device = params[0].device
        if len(params) > MAX_LEAVES:
            raise ValueError(f"fused optimizer: {len(params)} leaves, more than the "
                             f"{MAX_LEAVES} gradient pointers a launch carries")
        numels = [p.numel() for p in params]
        _check_leaves("parameter", params, device)
        _check_leaves("first moment", exp_avg, device, numels)
        _check_leaves("second moment", exp_avg_sq, device, numels)
        if len(lrs) != len(params) or len(sharded) != len(params):
            raise ValueError(f"fused optimizer: {len(lrs)} learning rates and "
                             f"{len(sharded)} shard flags for {len(params)} leaves")
        chunks = plan_chunks(numels)
        leaves = np.zeros(len(params), ADAM_LEAF)
        leaves["p"] = _pointers(params)
        leaves["m"] = _pointers(exp_avg)
        leaves["v"] = _pointers(exp_avg_sq)
        leaves["n"] = numels
        leaves["neg_lr"] = [-lr for lr in lrs]
        leaves["sharded"] = [bool(s) for s in sharded]
        axes = [three_axes(tuple(p.shape)) or (0, 0, 0) for p in params]
        leaves["inner"] = [a[1] for a in axes]
        leaves["taps"] = [a[2] for a in axes]
        self.key = self.key_of(params, exp_avg, exp_avg_sq, lrs, sharded)
        self.shapes = [p.shape for p in params]
        self.n_chunks = len(chunks)
        self.leaves = _upload(leaves, device)
        self.chunks = _upload(chunks, device)
        self.partials = torch.empty((self.n_chunks, 4), dtype=torch.float32, device=device)
        self.tickets = torch.zeros(2, dtype=torch.int32, device=device)
        self.totals = torch.zeros(4, dtype=torch.float32, device=device)
        self.grad_ptrs = np.zeros(len(params), np.uint64)
        self.orders = np.zeros(len(params), np.uint8)

    def step(self, grads: Sequence[Optional[torch.Tensor]], count: torch.Tensor,
             notfinite_count: torch.Tensor, hyper: AdamHyper,
             model_sum: Optional[Callable[[torch.Tensor], torch.Tensor]]) -> torch.Tensor:
        global adam_launches
        device, index = self.device, self.device.index
        if len(grads) != len(self.shapes):
            raise ValueError(f"clipped Adam: {len(grads)} gradients for {len(self.shapes)} "
                             "parameters")
        for name, c in (("count", count), ("notfinite_count", notfinite_count)):
            if c.dtype != torch.int32 or c.numel() != 1 or c.device != device:
                raise ValueError(f"clipped Adam: {name} must be one int32 on {device}, got "
                                 f"{c.dtype} {tuple(c.shape)} on {c.device}")
        copies = []
        for i, (g, shape) in enumerate(zip(grads, self.shapes)):
            if g is None:
                self.grad_ptrs[i] = 0
                self.orders[i] = 0
                continue
            if g.dtype != torch.float32 or g.shape != shape or g.get_device() != index:
                raise ValueError(
                    f"clipped Adam: gradient {i} must be an f32 {tuple(shape)} tensor on "
                    f"{device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
            order = 0
            if not g.is_contiguous():
                # cuDNN gives a conv weight's gradient in the activations'
                # memory order: the update gathers it; what the kernels do
                # not read is copied (one more launch)
                order = grad_order(tuple(shape), g.stride())
                if order is None:
                    g = g.contiguous()
                    copies.append(g)
                    order = 0
            self.grad_ptrs[i] = g.data_ptr()
            self.orders[i] = order
        lib = _library()
        applied = torch.empty((), dtype=torch.bool, device=device)
        totals = self.totals.data_ptr()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            common = (self.grad_ptrs.ctypes.data, self.orders.ctypes.data, len(self.shapes),
                      self.leaves.data_ptr(), self.chunks.data_ptr(), self.n_chunks)
            _check_rc(lib.adam_reduce(*common, self.partials.data_ptr(),
                                      self.tickets.data_ptr(), totals, stream), "Adam reduce")
            # the sharded sum and the non-finite flag over the model axis
            blocks = model_sum(self.totals[1:3]) if model_sum is not None else self.totals[1:3]
            _check_rc(lib.adam_update(
                *common, totals, blocks.data_ptr(), count.data_ptr(),
                notfinite_count.data_ptr(), applied.data_ptr(), self.tickets.data_ptr() + 4,
                hyper.b1, hyper.b2, 1.0 - hyper.b1, 1.0 - hyper.b2, hyper.eps,
                hyper.max_norm, int(hyper.skip_nonfinite),
                int(hyper.max_consecutive_nonfinite), stream), "Adam update")
        adam_launches += 2 + len(copies)
        return applied


class _EmaTables(NamedTuple):
    leaves: torch.Tensor
    chunks: torch.Tensor
    n_chunks: int


# The last EMA update's tables, by (e, p, numel) of every pair: the trainer
# has one generator pair, so they are built once.
_EMA_TABLES: Optional[tuple] = None


def _ema_tables(ema_params, params) -> _EmaTables:
    global _EMA_TABLES
    key = tuple((e.data_ptr(), p.data_ptr(), e.numel()) for e, p in zip(ema_params, params))
    if _EMA_TABLES is not None and _EMA_TABLES[0] == key:
        return _EMA_TABLES[1]
    device = ema_params[0].device
    if len(ema_params) != len(params):
        raise ValueError(f"EMA update: {len(ema_params)} EMA leaves for {len(params)}")
    numels = [e.numel() for e in ema_params]
    _check_leaves("EMA leaf", ema_params, device)
    _check_leaves("parameter", params, device, numels)
    chunks = plan_chunks(numels)
    leaves = np.zeros(len(params), EMA_LEAF)
    leaves["e"] = _pointers(ema_params)
    leaves["p"] = _pointers(params)
    leaves["n"] = numels
    tables = _EmaTables(_upload(leaves, device), _upload(chunks, device), len(chunks))
    _EMA_TABLES = (key, tables)
    return tables


def _ema_update_cuda(ema_params, params, decay: float) -> None:
    global ema_launches
    tables = _ema_tables(ema_params, params)
    device = ema_params[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check_rc(_library().ema_update(tables.leaves.data_ptr(), tables.chunks.data_ptr(),
                                        tables.n_chunks, decay, 1.0 - decay, stream), "EMA")
    ema_launches += 1
