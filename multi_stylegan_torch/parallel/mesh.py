"""Data and tensor parallelism over ``torch.distributed`` (the (data,
model) mesh of the JAX package's parallel/mesh.py).

The JAX package is one SPMD program over a global batch: every batch
reduction is global and every draw is a draw of the global array.  The port
runs one process (rank) per shard of the global batch and gets the same
numbers with explicit collectives:

* each rank's loss is its rows' share of the global mean (``global_mean``,
  ``global_total``: the value is the global one on every rank, the gradient
  is that of this rank's rows alone), and the gradients are summed over the
  ranks in one flat bucket per sub-step (``all_reduce_grads``);
* a reduction whose gradient reaches other ranks' rows (the minibatch
  standard deviation) goes through ``all_sum``, whose backward is itself an
  all-reduce, so R1's double backward crosses it;
* a rank owns a contiguous block of every global batch, process-major
  (``rows``), as the JAX ``per_host_batch`` lays out a global array.  A
  batch need not divide over the ranks: the first ``n % world`` ranks hold
  one row more (``numpy.array_split``'s rule), and a rank may hold none.
  Every reduction divides by the global count, which rides in the same
  all-reduce as the sums, and a rank with no rows still enters every
  collective with exact zeros;
* ranks start from the same state (``broadcast_state``) and stay bitwise
  replicas: the reduced values are the same bits on every rank.

The ranks form the JAX mesh's (data, model) grid with the model axis minor
(``create_device_mesh((n_data, n_model))``): global rank
``data_index * n_model + model_index``.  :func:`init` makes one process
group per data row (the model group, parallel/tensor.py's collectives) and
one per model column (the data group), every rank every group in the same
order.  :func:`world` and :func:`rank` are the data axis's (the rows of the
global batch); every batch collective here runs over the data group.  The
ranks of one model group hold the same rows, so their replicated values
agree.  With ``n_model == 1`` the data group is the world and nothing runs
over a model group.

Only ``all_reduce`` and ``broadcast`` are used (with ``barrier``): they are
what gloo offers for CUDA tensors.  A gather is a zero buffer of the global
shape that each rank fills at its rows, then all-reduced.  NCCL serves ranks
that each own a card; ranks sharing a card, or on the CPU, use gloo (NCCL
refuses two ranks on one device).  Without a process group (world size 1)
every function here is the plain single-process expression and no
collective runs.
"""

from __future__ import annotations

import datetime
import math
import pickle
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


_N_MODEL = 1
_DATA_GROUP = None  # None: the default group (the world), as at n_model == 1
_MODEL_GROUP = None


def process_count() -> int:
    """The number of ranks on both axes; 1 when no process group exists."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's global rank; 0 when no process group exists."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def model_world() -> int:
    """The size of the model axis (1 without tensor parallelism)."""
    return _N_MODEL


def model_rank() -> int:
    """This rank's index on the model axis."""
    return process_index() % _N_MODEL


def world() -> int:
    """The size of the data axis: the ranks the global batch's rows divide over."""
    return process_count() // _N_MODEL


def rank() -> int:
    """This rank's index on the data axis."""
    return process_index() // _N_MODEL


def writes() -> bool:
    """Whether this rank writes (metrics, grids, checkpoints): the first of
    both axes."""
    return rank() == 0 and model_rank() == 0


def model_group():
    """The process group of this rank's data row (tensor-parallel collectives)."""
    return _MODEL_GROUP


def init(world_size: int, rank_: int, init_method: str, device: torch.device,
         shares_card: bool = False, timeout_s: float = 1800.0, n_model: int = 1) -> str:
    """Join the process group of ``world_size`` ranks as ``rank_`` through
    ``init_method`` (``tcp://host:port`` or ``file://path``) on ``device``,
    laid out as a (``world_size / n_model``, ``n_model``) mesh; returns the
    backend: NCCL when every rank owns its card, gloo when ``shares_card``
    (other ranks run on this rank's card) or on the CPU."""
    global _N_MODEL, _DATA_GROUP, _MODEL_GROUP
    if n_model < 1 or world_size % n_model:
        raise ValueError(f"{world_size} ranks do not form a mesh with a model axis of {n_model}")
    backend = "nccl" if device.type == "cuda" and not shares_card else "gloo"
    kw = {"device_id": device} if backend == "nccl" else {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank_, timeout=timeout, **kw)
    if n_model > 1:
        n_data = world_size // n_model
        # every rank creates every group, in one order (NCCL hangs otherwise)
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)], timeout=timeout)
            if rank_ // n_model == d:
                _MODEL_GROUP = group
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)], timeout=timeout)
            if rank_ % n_model == m:
                _DATA_GROUP = group
        _N_MODEL = n_model
    return backend


def shutdown() -> None:
    global _N_MODEL, _DATA_GROUP, _MODEL_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _N_MODEL, _DATA_GROUP, _MODEL_GROUP = 1, None, None


def barrier() -> None:
    """Wait for every rank (the JAX ``process_barrier``); no-op alone."""
    if process_count() > 1:
        dist.barrier()


# ----------------------------------------------------------------- rows


def counts(n: int) -> List[int]:
    """The rows of a global batch of ``n`` each data rank owns, in rank
    order: the first ``n % world`` ranks one more (``numpy.array_split``)."""
    per, extra = divmod(n, world())
    return [per + (r < extra) for r in range(world())]


def rows(n: int) -> slice:
    """The rows of a global batch of ``n`` this rank owns, process-major
    (:func:`counts`; the block may be empty)."""
    c = counts(n)
    start = sum(c[:rank()])
    return slice(start, start + c[rank()])


def shard(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global tensor (the tensor itself alone)."""
    return x if world() == 1 else x[rows(x.shape[0])]


def gather_rows(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """The global tensor of ``n`` rows whose rows the ranks hold as ``x``
    (not differentiable; ``n`` defaults to an even layout's
    ``x.shape[0] * world``): each rank writes its rows into zeros, then a
    sum."""
    w = world()
    if w == 1:
        return x
    n = x.shape[0] * w if n is None else n
    mine = rows(n)
    if mine.stop - mine.start != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows are not rank {rank()}'s share of {n}")
    full = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    full[mine] = x.detach()
    dist.all_reduce(full, group=_DATA_GROUP)
    return full


def head_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's share (``rows(n)``) of the first ``n`` global rows of the
    batch whose rows the ranks hold as ``x``, an even layout (the
    wrong-order batch: the first rows all live on the first ranks)."""
    if world() == 1:
        return x[:n]
    lo = rank() * x.shape[0]
    head = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    take = max(0, min(n, lo + x.shape[0]) - lo)
    head[lo:lo + take] = x[:take].detach()
    dist.all_reduce(head, group=_DATA_GROUP)
    return head[rows(n)]


# ------------------------------------------------------------ reductions


class _Sum(torch.autograd.Function):
    """All-reduce SUM over the data axis whose backward is the same
    all-reduce of the cotangent (so it is differentiable any number of
    times)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=_DATA_GROUP)
        return out

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data axis, differentiable (and its gradient
    again); ``x`` itself alone."""
    return x if world() == 1 else _Sum.apply(x)


def _straight_through(parts: torch.Tensor) -> torch.Tensor:
    """The all-reduced ``parts`` as values, with the gradient of this rank's
    ``parts``: ``total + (part - part)`` adds an exact zero, so every rank
    holds the same bits."""
    total = parts.detach().reshape(-1).clone()
    dist.all_reduce(total, group=_DATA_GROUP)
    return total.view_as(parts) + (parts - parts.detach())


def global_mean(*xs: torch.Tensor):
    """The mean of each ``x`` (rows on dim 0) over the global batch, in one
    all-reduce of the sums and the row counts: its value on every rank, and
    the gradient of this rank's rows' share (a rank with no rows adds exact
    zeros).  ``x.mean()`` alone."""
    if world() == 1:
        out = [x.mean() for x in xs]
    else:
        sums = torch.stack([x.sum() for x in xs])
        # f32 at least: the row counts are exact integers
        dt = torch.promote_types(sums.dtype, torch.float32)
        local = torch.cat([sums.to(dt), torch.tensor([float(x.shape[0]) for x in xs],
                                                     dtype=dt, device=sums.device)])
        both = _straight_through(local)
        per_row = torch.tensor([float(math.prod(x.shape[1:])) for x in xs], dtype=dt,
                               device=sums.device)
        out = list((both[:len(xs)] / (both[len(xs):].detach() * per_row)).to(sums.dtype)
                   .unbind(0))
    return out[0] if len(out) == 1 else tuple(out)


def global_total(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the global batch, with the gradient of this
    rank's rows; ``x.sum()`` alone."""
    return x.sum() if world() == 1 else _straight_through(x.sum())


def total(x: torch.Tensor) -> torch.Tensor:
    """The sum of a tensor over the data axis, not differentiable."""
    if world() == 1:
        return x
    out = x.detach().reshape(-1).clone()
    dist.all_reduce(out, group=_DATA_GROUP)
    return out.view_as(x)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a tensor over the model axis, not differentiable."""
    if _N_MODEL == 1:
        return x
    out = x.detach().reshape(-1).clone()
    dist.all_reduce(out, group=_MODEL_GROUP)
    return out.view_as(x)


def any_rank(flag: bool, device: torch.device) -> bool:
    """True on every rank (both axes) when ``flag`` is true on any (a MAX
    all-reduce)."""
    if process_count() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]],
                     shard_dims: Optional[Sequence[Optional[int]]] = None,
                     params: Optional[Sequence[torch.Tensor]] = None
                     ) -> List[Optional[torch.Tensor]]:
    """The gradients summed over the data axis, one flat bucket per kind (the
    models' parameters are all f32).  A None (an unused parameter) stays
    None, and must be None on every rank unless ``params`` (aligned with
    ``grads``) is given: then a gradient may be None on some ranks only
    (autograd gives None where a rank's zero rows never reach a parameter,
    :func:`rows`), is sent as zeros of its parameter's shape with a flag a
    gradient in the same bucket, and comes back None where it was None on
    every rank (one host read of the flags).  ``shard_dims`` marks the
    tensor-parallel slices (parallel/tensor.py): those sum over the data
    axis alone, while every replicated gradient sums over all ranks and is
    divided by the model axis, so each model rank applies the same bits
    even where its backward added in another order (cuDNN's atomics)."""
    grads = list(grads)
    if process_count() == 1:
        return grads
    dims = shard_dims or [None] * len(grads)
    like = params or grads
    out = list(grads)
    for sliced, group, n in ((False, None, _N_MODEL), (True, _DATA_GROUP, 1)):
        if sliced and world() == 1:
            continue
        idx = [i for i in range(len(grads)) if (dims[i] is not None) == sliced
               and (params is not None or grads[i] is not None)]
        if not idx:
            continue
        parts = [grads[i].reshape(-1) if grads[i] is not None
                 else torch.zeros_like(like[i]).reshape(-1) for i in idx]
        if params is not None:
            parts.append(parts[0].new_tensor([float(grads[i] is not None) for i in idx]))
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)
        seen = flat[-len(idx):].tolist() if params is not None else [1.0] * len(idx)
        at = 0
        for i, s in zip(idx, seen):
            out[i] = flat[at:at + like[i].numel()].view(like[i].shape) if s > 0 else None
            at += like[i].numel()
    return out


# --------------------------------------------------------------- state


def tensors_of(obj) -> List[torch.Tensor]:
    """Every tensor of a tensor, a module or a dict / list / tuple of them,
    in a fixed order (dicts by key)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.state_dict(keep_vars=True).values())
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in tensors_of(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors_of(v)]
    return []


@torch.no_grad()
def broadcast_state(tree) -> None:
    """Every tensor of ``tree`` (a training state's
    ``io/checkpoint.py::train_state_dict``, a module, a list) from the first
    rank of this rank's data column, in place (the JAX ``replicate_state``;
    each model rank's slices from the first rank holding them)."""
    if world() == 1:
        return
    for t in tensors_of(tree):
        dist.broadcast(t.data, src=model_rank(), group=_DATA_GROUP)


@torch.no_grad()
def broadcast_everywhere(tree) -> None:
    """Every tensor of ``tree`` from global rank 0 to every rank, in place."""
    if process_count() == 1:
        return
    for t in tensors_of(tree):
        dist.broadcast(t.data, src=0)


def _object_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def broadcast_object(obj: Any) -> Any:
    """Global rank 0's ``obj`` on every rank (pickled through a byte tensor)."""
    if process_count() == 1:
        return obj
    dev = _object_device()
    data = pickle.dumps(obj) if process_index() == 0 else b""
    size = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    dist.broadcast(size, src=0)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=dev)
    if process_index() == 0:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    return pickle.loads(buf.cpu().numpy().tobytes())


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in global rank order, on every rank (pickled
    bytes gathered through a zero buffer)."""
    w = process_count()
    if w == 1:
        return [obj]
    dev = _object_device()
    data = pickle.dumps(obj)
    sizes = torch.zeros(w, dtype=torch.int64, device=dev)
    sizes[process_index()] = len(data)
    dist.all_reduce(sizes)
    buf = torch.zeros((w, int(sizes.max().item())), dtype=torch.uint8, device=dev)
    buf[process_index(), :len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    dist.all_reduce(buf)
    host = buf.cpu().numpy()
    return [pickle.loads(host[r, :int(sizes[r])].tobytes()) for r in range(w)]
