"""Synthetic TLFM-shaped fixture for smoke training without data (the JAX
package's data/synthetic.py::SyntheticTLFMDataset, same numbers).

[C, T, H, W] sequences of drifting Gaussian "cells" (bright blobs on the BF
channel, sparse fluorescent blobs on GFP/RFP) in [0, 1], numpy f32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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


def iterate_batches(dataset, batch_size: int, rng: np.random.Generator):
    """One epoch of shuffled [B, ...] numpy batches, the last partial batch
    dropped (the JAX package's BatchLoader order for the same ``rng``)."""
    if len(dataset) < batch_size:
        raise ValueError(f"dataset of {len(dataset)} samples cannot fill a batch of {batch_size}")
    idx = np.arange(len(dataset))
    rng.shuffle(idx)
    for b in range(len(dataset) // batch_size):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        yield np.stack([dataset[i] for i in sel])
