"""The training input pipeline: a ``torch.utils.data.DataLoader`` over a
dataset of [C, T, H, W] numpy sequences, in the JAX package's batch order
(data/pipeline.py:19-115).

Each epoch :class:`EpochSampler` shuffles ``arange(len(dataset))`` with one
``np.random.default_rng(seed)`` kept across epochs, exactly as the JAX
``BatchLoader`` draws its permutation, and the loader batches it dropping
the last partial batch: both loaders visit the same sequences in the same
order.  As the JAX loader, :func:`make_loader` can also keep the dataset's
order (``shuffle=False``, as validation streams its real samples).

Items are read by ``num_workers`` worker *processes* (started with
``spawn`` and kept across epochs): decoding an LZW TIFF in Python holds the
interpreter lock, so threads would not overlap it.  Each worker holds its
own copy of the dataset, so :func:`_seed_worker` reseeds that copy's flip
rng from (seed, worker id); otherwise every worker would draw the same
flips.  The flips then equal the JAX loader's only at ``num_workers=0``,
where the items are read in the calling process in index order; the JAX
loader's own 8 threads share one rng in scheduling order, so its flips are
not reproducible there either.  Batches land in pinned memory when the
target device is CUDA.

Under data parallelism (parallel/mesh.py) every rank draws the same epoch
permutation and loads only its process-major slice of each global batch,
as the JAX loader does per process (pipeline.py:42-58, 93-104); each rank's
dataset draws the flips of the items it loads.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler, get_worker_info

from multi_stylegan_torch.parallel import mesh


class EpochSampler(Sampler[int]):
    """A fresh permutation of the dataset's indices per epoch, drawn as the
    JAX ``BatchLoader._epoch_indices`` draws it (or the dataset's order,
    without ``shuffle``).  With ``world`` ranks it yields, of each whole
    global batch of ``batch_size``, the slice of rank ``rank``."""

    def __init__(self, n: int, seed: int = 0, batch_size: int = 1, rank: int = 0,
                 world: int = 1, shuffle: bool = True) -> None:
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.batch_size, self.rank, self.world = batch_size, rank, world
        self.shuffle = shuffle

    def __len__(self) -> int:
        if self.world == 1:
            return self.n
        return self.n // self.batch_size * (self.batch_size // self.world)

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(idx)
        if self.world > 1:
            per = self.batch_size // self.world
            idx = idx[:self.n // self.batch_size * self.batch_size].reshape(
                -1, self.world, per)[:, self.rank].reshape(-1)
        return iter(idx.tolist())


def _seed_worker(seed: int, worker_id: int) -> None:
    dataset = get_worker_info().dataset
    if hasattr(dataset, "rng"):
        dataset.rng = np.random.default_rng((seed, worker_id))


def make_loader(dataset, batch_size: int, seed: int = 0, num_workers: int = 0,
                device: torch.device = torch.device("cpu"),
                shuffle: bool = True) -> DataLoader:
    """The loader of ``dataset`` for ``device``, dropping the last partial
    batch and shuffled unless asked otherwise (JAX pipeline.py:23-33); under
    data parallelism ``batch_size`` is the global batch and the loader
    yields this rank's rows of it."""
    if len(dataset) < batch_size:
        raise ValueError(f"dataset of {len(dataset)} samples cannot fill a batch of {batch_size}")
    world = mesh.world()
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} not divisible by {world} ranks")
    workers = dict(num_workers=num_workers, multiprocessing_context="spawn",
                   persistent_workers=True, prefetch_factor=2,
                   worker_init_fn=functools.partial(_seed_worker, seed)) if num_workers else {}
    sampler = EpochSampler(len(dataset), seed, batch_size, mesh.rank(), world, shuffle)
    return DataLoader(dataset, batch_size=batch_size // world, sampler=sampler,
                      drop_last=True, pin_memory=torch.device(device).type == "cuda", **workers)


def loader_state(loader: DataLoader) -> Dict[str, Any]:
    """What a checkpoint keeps of the loader: the sampler's bit-generator
    state and, when items are read in this process, the dataset's flip rng."""
    state = {"sampler": loader.sampler.rng.bit_generator.state}
    if loader.num_workers == 0 and hasattr(loader.dataset, "rng"):
        state["dataset"] = loader.dataset.rng.bit_generator.state
    return state


def load_loader_state(loader: DataLoader, state: Dict[str, Any]) -> None:
    loader.sampler.rng.bit_generator.state = state["sampler"]
    if "dataset" in state and loader.num_workers == 0:
        loader.dataset.rng.bit_generator.state = state["dataset"]
