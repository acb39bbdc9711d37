"""One process: the port's data-axis reductions (parallel/mesh.py) and
tensor-parallel helpers (parallel/tensor.py) at world size 1, where each is
the plain expression."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def world() -> int:
    return 1


def process_count() -> int:
    return 1


def rows(n: int) -> slice:
    return slice(0, n)


def shard(x: torch.Tensor) -> torch.Tensor:
    return x


def gather_rows(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    return x


def head_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    return x[:n]


def all_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def global_mean(*xs: torch.Tensor):
    out = [x.mean() for x in xs]
    return out[0] if len(out) == 1 else tuple(out)


def global_total(x: torch.Tensor) -> torch.Tensor:
    return x.sum()


def total(x: torch.Tensor) -> torch.Tensor:
    return x


def model_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]], shard_dims=None,
                     params=None) -> List[Optional[torch.Tensor]]:
    return list(grads)


def gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return x


def copy(x: torch.Tensor) -> torch.Tensor:
    return x


def shard_dims(model, params: Sequence[torch.Tensor]) -> list:
    return [None] * len(params)


def full_tensor(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    return x


def local_block(full: torch.Tensor, like: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    return full
