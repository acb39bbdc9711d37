"""The random draws of the training iteration, made by the benchmark from
the seed and handed to both sides.

:class:`SeededDraws` draws from one ``torch.Generator`` and answers the
port's draws protocol (``multi_stylegan_torch/train/draws.py``: latents,
inject index, noise, permutation, cut-mix, ADA, path-length probe).  With
``record`` it keeps every raw draw; :class:`Replay` gives the same draws
again, in the same order, to the reference.  What depends on the training
state is kept raw and worked out by the caller's state: the ADA gates are
uniforms compared with the caller's ADA probability, the mixing coin with
the caller's ``p_mixed_noise``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from gpu_bench.reference.ada import LOGNORMAL_SIGMA, AdaDraws
from gpu_bench.reference.discriminator import cut_mix_coordinate_ranges

GATES = ("flip", "rot90", "translate", "iso", "rot1", "aniso", "rot2")


def mixing(raw, p_mixed_noise: float):
    z1, z2, coin = raw
    use = coin < p_mixed_noise if p_mixed_noise > 0 else torch.zeros_like(coin, dtype=torch.bool)
    return z1, z2, use


def ada_draws(raw: dict, p: torch.Tensor) -> AdaDraws:
    """The pipeline's draws from raw ones and the ADA probability ``p``
    (a gate is its uniform < p; the rotations' < 1 - sqrt(1 - p))."""
    p = torch.as_tensor(p, dtype=torch.float32, device=raw["flip"].device)
    p_rot = 1.0 - torch.sqrt(torch.clamp(1.0 - p, 0.0, 1.0))
    gates = {k: raw[k] < (p_rot if k in ("rot1", "rot2") else p) for k in GATES}
    return AdaDraws(rot90_index=raw["rot90_index"], shift=raw["shift"], s_iso=raw["s_iso"],
                    angle=raw["angle"], s_aniso=raw["s_aniso"], angle2=raw["angle2"], **gates)


class SeededDraws:
    """Draws from ``generator`` on its device; ``record`` keeps each raw draw."""

    def __init__(self, generator: torch.Generator, record: bool = False):
        self.generator = generator
        self.device = generator.device
        self.records: List[Tuple[str, object]] = [] if record else None

    def _keep(self, kind: str, raw):
        if self.records is not None:
            self.records.append((kind, raw))
        return raw

    def _randn(self, *shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.generator, device=self.device)

    def _randint(self, lo: int, hi: int, shape=()):
        return torch.randint(lo, hi, shape, generator=self.generator, device=self.device)

    def latents(self, batch: int, dim: int, p_mixed_noise: float):
        raw = (self._randn(batch, dim), self._randn(batch, dim), self._rand())
        return mixing(self._keep("latents", raw), p_mixed_noise)

    def inject_index(self, n_latents: int) -> torch.Tensor:
        return self._keep("inject", self._randint(1, n_latents - 1))

    def noise(self, batch: int, shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        return self._keep("noise", [self._randn(batch, 1, h, w) for h, w in shapes])

    def permutation(self, n: int) -> torch.Tensor:
        """Indices drawn with replacement; the identity becomes the reverse."""
        perm = self._randint(0, n, (n,))
        ident = torch.arange(n, device=self.device)
        return self._keep("permutation", torch.where((perm == ident).all(), ident.flip(0), perm))

    def cut_mix(self, height: int, width: int):
        (h0, h1), (w0, w1) = cut_mix_coordinate_ranges(height, width)
        return self._keep("cut_mix", (self._randint(h0, h1), self._randint(w0, w1),
                                      self._rand() > 0.5, self._rand() > 0.5))

    def ada(self, batch: int, height: int, width: int, p: torch.Tensor) -> AdaDraws:
        max_h, max_w = max(1, int(0.125 * height)), max(1, int(0.125 * width))
        raw = {"flip": self._rand(batch), "rot90_index": self._randint(0, 4),
               "rot90": self._rand(batch),
               "shift": torch.stack([self._randint(-max_h, max_h + 1),
                                     self._randint(-max_w, max_w + 1)]),
               "translate": self._rand(batch),
               "s_iso": torch.exp(self._randn(batch, 1) * LOGNORMAL_SIGMA),
               "iso": self._rand(batch), "angle": self._rand(batch) * 360.0 - 180.0,
               "rot1": self._rand(batch),
               "s_aniso": torch.exp(self._randn(batch, 2) * LOGNORMAL_SIGMA),
               "aniso": self._rand(batch), "angle2": self._rand(batch) * 360.0 - 180.0,
               "rot2": self._rand(batch)}
        return ada_draws(self._keep("ada", raw), p)

    def path_length_probe(self, shape: Sequence[int]) -> torch.Tensor:
        return self._keep("probe", self._randn(*shape))


class Replay:
    """The draws of a recorded :class:`SeededDraws`, in order, on ``device``."""

    def __init__(self, records: List[Tuple[str, object]], device: torch.device):
        self.records = list(records)
        self.device = torch.device(device)
        self.i = 0

    def _next(self, kind: str):
        if self.i >= len(self.records):
            raise RuntimeError(f"replay: no draw left for {kind}")
        got, raw = self.records[self.i]
        if got != kind:
            raise RuntimeError(f"replay: draw {self.i} is {got}, the reference asks for {kind}")
        self.i += 1
        return _to(raw, self.device)

    def latents(self, batch: int, dim: int, p_mixed_noise: float):
        raw = self._next("latents")
        if raw[0].shape != (batch, dim):
            raise RuntimeError(f"replay: latents {tuple(raw[0].shape)}, asked {(batch, dim)}")
        return mixing(raw, p_mixed_noise)

    def inject_index(self, n_latents: int) -> torch.Tensor:
        return self._next("inject")

    def noise(self, batch: int, shapes) -> List[torch.Tensor]:
        raw = self._next("noise")
        if [tuple(n.shape) for n in raw] != [(batch, 1, h, w) for h, w in shapes]:
            raise RuntimeError("replay: noise shapes differ")
        return raw

    def permutation(self, n: int) -> torch.Tensor:
        return self._next("permutation")

    def cut_mix(self, height: int, width: int):
        return self._next("cut_mix")

    def ada(self, batch: int, height: int, width: int, p: torch.Tensor) -> AdaDraws:
        raw = self._next("ada")
        if raw["flip"].shape[0] != batch:
            raise RuntimeError(f"replay: ADA rows {raw['flip'].shape[0]}, asked {batch}")
        return ada_draws(raw, p)

    def path_length_probe(self, shape) -> torch.Tensor:
        raw = self._next("probe")
        if tuple(raw.shape) != tuple(shape):
            raise RuntimeError("replay: probe shape differs")
        return raw


def _to(raw, device):
    if isinstance(raw, torch.Tensor):
        return raw.to(device)
    if isinstance(raw, dict):
        return {k: _to(v, device) for k, v in raw.items()}
    if isinstance(raw, (list, tuple)):
        return type(raw)(_to(v, device) for v in raw)
    return raw
