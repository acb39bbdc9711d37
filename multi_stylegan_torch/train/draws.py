"""The random draws of a training step, behind one injectable provider.

The JAX step derives every draw from a PRNG key schedule; the port's step
asks a provider instead, so a test can hand it the JAX schedule's numbers
and a run can use its own generator.  :class:`TorchDraws` is the default:
one ``torch.Generator`` on the device, and every draw stays on the device
(no host sync).  A provider has these methods:

* ``latents(batch, dim, p_mixed_noise)`` -> (z1, z2, use_mixing)
* ``inject_index(n_latents)`` -> 0-d long in [1, n_latents - 1)
* ``noise(batch, shapes)`` -> per-layer [batch, 1, H, W] N(0, 1) maps
* ``permutation(n)`` -> the wrong-order time indices (with replacement)
* ``cut_mix(height, width)`` -> (row, col, corner, invert) of a cut-mix map
* ``ada(batch, height, width, p)`` -> :class:`~multi_stylegan_torch.train.ada.AdaDraws`
* ``path_length_probe(shape)`` -> N(0, 1) of the image's shape

Under data parallelism the step asks for the draws of the global batch and
:class:`ShardDraws` keeps this rank's rows of them (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from multi_stylegan_torch.models.discriminator import cut_mix_coordinate_ranges
from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.train.ada import AdaDraws, draw_ada
from multi_stylegan_torch.train.noise import get_noise, random_permutation


class TorchDraws:
    """Draws from one ``torch.Generator`` on the device it lives on."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def latents(self, batch: int, dim: int, p_mixed_noise: float):
        return get_noise(self.generator, batch, dim, p_mixed_noise)

    def inject_index(self, n_latents: int) -> torch.Tensor:
        return torch.randint(1, n_latents - 1, (), generator=self.generator, device=self.device)

    def noise(self, batch: int, shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        return [torch.randn((batch, 1, h, w), generator=self.generator, device=self.device)
                for h, w in shapes]

    def permutation(self, n: int) -> torch.Tensor:
        return random_permutation(self.generator, n)

    def cut_mix(self, height: int, width: int):
        (h0, h1), (w0, w1) = cut_mix_coordinate_ranges(height, width)
        g, dev = self.generator, self.device
        return (torch.randint(h0, h1, (), generator=g, device=dev),
                torch.randint(w0, w1, (), generator=g, device=dev),
                torch.rand((), generator=g, device=dev) > 0.5,
                torch.rand((), generator=g, device=dev) > 0.5)

    def ada(self, batch: int, height: int, width: int, p: torch.Tensor) -> AdaDraws:
        return draw_ada(self.generator, batch, height, width, p)

    def path_length_probe(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)


class ShardDraws:
    """This rank's rows of the global draws of ``inner`` (any provider).

    Every rank holds the same seeded provider and draws the global tensor of
    every call, so the providers' states stay equal on every rank and the
    rows equal one process's draws at the global batch.  Per-batch draws
    (the mixing coin and slot, the permutation, the cut-mix map, ADA's
    rotation angle and shift) are kept whole."""

    # AdaDraws fields drawn once per batch, not per image
    ADA_PER_BATCH = ("rot90_index", "shift")

    def __init__(self, inner):
        self.inner = inner

    @property
    def generator(self) -> torch.Generator:
        """The inner provider's generator (a checkpoint keeps its state)."""
        return self.inner.generator

    def latents(self, batch: int, dim: int, p_mixed_noise: float):
        z1, z2, use_mix = self.inner.latents(batch, dim, p_mixed_noise)
        return mesh.shard(z1), mesh.shard(z2), use_mix

    def inject_index(self, n_latents: int) -> torch.Tensor:
        return self.inner.inject_index(n_latents)

    def noise(self, batch: int, shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        return [mesh.shard(n) for n in self.inner.noise(batch, shapes)]

    def permutation(self, n: int) -> torch.Tensor:
        return self.inner.permutation(n)

    def cut_mix(self, height: int, width: int):
        return self.inner.cut_mix(height, width)

    def ada(self, batch: int, height: int, width: int, p: torch.Tensor) -> AdaDraws:
        d = self.inner.ada(batch, height, width, p)
        return dataclasses.replace(d, **{f.name: mesh.shard(getattr(d, f.name))
                                         for f in dataclasses.fields(d)
                                         if f.name not in self.ADA_PER_BATCH})

    def path_length_probe(self, shape: Sequence[int]) -> torch.Tensor:
        return mesh.shard(self.inner.path_length_probe(shape))
