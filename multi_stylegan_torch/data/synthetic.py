"""Synthetic TLFM-shaped fixtures for training without data (the JAX
package's data/synthetic.py).

:class:`SyntheticTLFMDataset` (same numbers as the JAX one): [C, T, H, W]
sequences of drifting Gaussian "cells" (bright blobs on the BF channel,
sparse fluorescent blobs on GFP/RFP) in [0, 1], numpy f32.
:class:`TeacherTLFMDataset`: samples of a frozen random generator.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


class SyntheticTLFMDataset:
    def __init__(self, n_samples: int = 64, resolution: Tuple[int, int] = (256, 256),
                 sequence_length: int = 3, channels: int = 2, seed: int = 0) -> None:
        self.n_samples = n_samples
        self.resolution = resolution
        self.sequence_length = sequence_length
        self.channels = channels
        self.seed = seed

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, item: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + int(item))
        h, w = self.resolution
        t = self.sequence_length
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        out = np.zeros((self.channels, t, h, w), np.float32)
        n_cells = rng.integers(2, 6)
        centers = rng.uniform(0.2, 0.8, size=(n_cells, 2)) * [h, w]
        radii = rng.uniform(0.03, 0.08, size=n_cells) * min(h, w)
        drift = rng.uniform(-0.01, 0.01, size=(n_cells, 2)) * min(h, w)
        for step in range(t):
            for c, r, d in zip(centers, radii, drift):
                cy, cx = c + d * step
                blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)))
                out[0, step] += blob
                if self.channels > 1:
                    out[1, step] += 0.5 * blob * (r > 0.05 * min(h, w))
                if self.channels > 2:
                    out[2, step] += 0.3 * blob * (r < 0.05 * min(h, w))
        out += rng.normal(0, 0.02, size=out.shape).astype(np.float32)
        return np.clip(out, 0.0, 1.0)



class TeacherTLFMDataset:
    """"Real" sequences sampled once from a FROZEN random generator (JAX
    data/synthetic.py:56-121).

    The blob fixture is trivially separable from generator samples, so the
    discriminator saturates and ADA's p pins at 0; a teacher generator makes
    the target realizable by the student, so the game can balance.  The
    samples are drawn once, ``batch`` at a time, on the generator's device,
    and each sample's channel is min-max scaled to [0, 1] (the TLFM
    contract).  Without ``generator`` the teacher is a 512-channel
    ``Generator`` at ``resolution`` in ``compute_dtype``, with the reference
    init from ``seed``, on ``device``.  The draws are not the JAX package's
    (its PRNG is not torch's); :meth:`draw` gives each batch's latents and
    noise."""

    def __init__(self, n_samples: int = 256, resolution: Tuple[int, int] = (256, 256),
                 seed: int = 17, generator=None, batch: int = 16,
                 compute_dtype: str = "bfloat16", device=None) -> None:
        from multi_stylegan_torch.models.config import GeneratorConfig
        from multi_stylegan_torch.models.generator import Generator

        if generator is None:
            n_stages = max(1, int(np.log2(resolution[0] // 4)))
            generator = Generator(GeneratorConfig(channels=(512,) * (n_stages + 1),
                                                  compute_dtype=compute_dtype, remat=False))
            generator.reset_parameters(torch.Generator().manual_seed(seed))
            generator = generator.to(device or "cpu")
        if generator.config.resolution != tuple(resolution):
            raise ValueError(f"teacher resolution {generator.config.resolution} "
                             f"is not {tuple(resolution)}")
        dev = next(generator.parameters()).device
        rng = torch.Generator(device=dev).manual_seed(seed + 3)
        outs = []
        with torch.no_grad():
            for i in range(math.ceil(n_samples / batch)):
                z, noise = self.draw(i, batch, generator, rng)
                outs.append(generator(z, noise=noise).float().cpu().numpy())
        imgs = np.concatenate(outs, axis=0)[:n_samples]  # [N, D, T, H, W]
        lo = imgs.min(axis=(2, 3, 4), keepdims=True)
        hi = imgs.max(axis=(2, 3, 4), keepdims=True)
        self._data = (imgs - lo) / np.maximum(hi - lo, 1e-6)

    @staticmethod
    def draw(index: int, batch: int, generator,
             rng: torch.Generator) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The latents [batch, D] and per-layer noise of sample batch
        ``index``, from ``rng``."""
        z = torch.randn((batch, generator.config.latent_dimensions), generator=rng,
                        device=rng.device)
        return z, generator.random_noise(batch, rng)

    def __len__(self) -> int:
        return self._data.shape[0]

    def __getitem__(self, item: int) -> np.ndarray:
        return self._data[item]
