"""The reference's data-axis reductions over ``torch.distributed``: the
counterpart of ``single.py`` for a reference run over the same ranks as the
port (the port's ``parallel/mesh.py`` at a data axis of every rank, in plain
``all_reduce`` calls).

Each rank holds a contiguous block of every global batch, process-major,
the first ``n % world`` ranks one row more; a loss is its rows' share of the
global mean, the gradients are summed over the ranks in one flat bucket, and
the minibatch standard deviation's sums cross the ranks differentiably
(``all_sum``), as in the port.  :func:`install` puts these functions in
``single``'s place, where every reference module looks them up, for the
rest of the process (a rank's own).  :class:`ShardReplay` gives a rank its
rows of the replayed global draws, as the port's ``ShardDraws`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from gpu_bench.reference import single

NAMES = ("world", "process_count", "rows", "shard", "gather_rows", "head_rows", "all_sum",
         "global_mean", "global_total", "total", "all_reduce_grads")


def world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


process_count = world


def rank() -> int:
    return dist.get_rank() if world() > 1 else 0


def counts(n: int) -> List[int]:
    per, extra = divmod(n, world())
    return [per + (r < extra) for r in range(world())]


def rows(n: int) -> slice:
    c = counts(n)
    start = sum(c[:rank()])
    return slice(start, start + c[rank()])


def shard(x: torch.Tensor) -> torch.Tensor:
    return x if world() == 1 else x[rows(x.shape[0])]


def gather_rows(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """The global tensor of ``n`` rows (not differentiable): each rank
    writes its rows into zeros, then a sum."""
    if world() == 1:
        return x
    n = x.shape[0] * world() if n is None else n
    full = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    full[rows(n)] = x.detach()
    dist.all_reduce(full)
    return full


def head_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's share of the first ``n`` global rows of an even layout."""
    if world() == 1:
        return x[:n]
    lo = rank() * x.shape[0]
    head = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    take = max(0, min(n, lo + x.shape[0]) - lo)
    head[lo:lo + take] = x[:take].detach()
    dist.all_reduce(head)
    return head[rows(n)]


class _Sum(torch.autograd.Function):
    """An all-reduce sum whose backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    return x if world() == 1 else _Sum.apply(x)


def _straight_through(parts: torch.Tensor) -> torch.Tensor:
    """The all-reduced values with the gradient of this rank's ``parts``."""
    summed = parts.detach().reshape(-1).clone()
    dist.all_reduce(summed)
    return summed.view_as(parts) + (parts - parts.detach())


def global_mean(*xs: torch.Tensor):
    """Each mean over the global batch: one all-reduce of the sums and the
    row counts; the gradient of this rank's rows' share."""
    if world() == 1:
        out = [x.mean() for x in xs]
        return out[0] if len(out) == 1 else tuple(out)
    sums = torch.stack([x.sum() for x in xs])
    dt = torch.promote_types(sums.dtype, torch.float32)
    local = torch.cat([sums.to(dt), torch.tensor([float(x.shape[0]) for x in xs], dtype=dt,
                                                 device=sums.device)])
    both = _straight_through(local)
    per_row = torch.tensor([float(math.prod(x.shape[1:])) for x in xs], dtype=dt,
                           device=sums.device)
    out = list((both[:len(xs)] / (both[len(xs):].detach() * per_row)).to(sums.dtype).unbind(0))
    return out[0] if len(out) == 1 else tuple(out)


def global_total(x: torch.Tensor) -> torch.Tensor:
    return x.sum() if world() == 1 else _straight_through(x.sum())


def total(x: torch.Tensor) -> torch.Tensor:
    if world() == 1:
        return x
    out = x.detach().reshape(-1).clone()
    dist.all_reduce(out)
    return out.view_as(x)


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]], shard_dims=None,
                     params: Optional[Sequence[torch.Tensor]] = None
                     ) -> List[Optional[torch.Tensor]]:
    """The gradients summed over the ranks in one flat bucket; with
    ``params`` a gradient may be None on some ranks only (zeros and a flag
    are sent), and comes back None where it was None on every rank."""
    grads = list(grads)
    if world() == 1:
        return grads
    like = params or grads
    idx = [i for i in range(len(grads)) if params is not None or grads[i] is not None]
    if not idx:
        return grads
    parts = [grads[i].reshape(-1) if grads[i] is not None
             else torch.zeros_like(like[i]).reshape(-1) for i in idx]
    if params is not None:
        parts.append(parts[0].new_tensor([float(grads[i] is not None) for i in idx]))
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    seen = flat[-len(idx):].tolist() if params is not None else [1.0] * len(idx)
    out, at = list(grads), 0
    for i, s in zip(idx, seen):
        out[i] = flat[at:at + like[i].numel()].view(like[i].shape) if s > 0 else None
        at += like[i].numel()
    return out


def install() -> None:
    """These reductions in ``single``'s place, for the rest of the process."""
    for name in NAMES:
        setattr(single, name, globals()[name])


class ShardReplay:
    """This rank's rows of a :class:`~gpu_bench.reference.draws.Replay` of
    the global draws; the per-batch draws (the mixing coin, the inject
    index, the permutation, the cut-mix map, ADA's rotation index and
    shift) are kept whole."""

    ADA_PER_BATCH = ("rot90_index", "shift")

    def __init__(self, inner):
        self.inner = inner

    def latents(self, batch: int, dim: int, p_mixed_noise: float):
        z1, z2, use_mix = self.inner.latents(batch, dim, p_mixed_noise)
        return shard(z1), shard(z2), use_mix

    def inject_index(self, n_latents: int) -> torch.Tensor:
        return self.inner.inject_index(n_latents)

    def noise(self, batch: int, shapes) -> List[torch.Tensor]:
        return [shard(n) for n in self.inner.noise(batch, shapes)]

    def permutation(self, n: int) -> torch.Tensor:
        return self.inner.permutation(n)

    def cut_mix(self, height: int, width: int):
        return self.inner.cut_mix(height, width)

    def ada(self, batch: int, height: int, width: int, p: torch.Tensor):
        d = self.inner.ada(batch, height, width, p)
        return dataclasses.replace(d, **{f.name: shard(getattr(d, f.name))
                                         for f in dataclasses.fields(d)
                                         if f.name not in self.ADA_PER_BATCH})

    def path_length_probe(self, shape) -> torch.Tensor:
        return shard(self.inner.path_length_probe(shape))
