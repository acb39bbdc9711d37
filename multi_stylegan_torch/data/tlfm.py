"""TLFM (trapped-yeast time-lapse fluorescence microscopy) dataset, the
port's copy of the JAX package's data/tlfm.py with every quirk kept
(reference dataset/tlfm_dataset.py + dataset/utils.py):

* position folders scanned for ``.tif`` files; the channel is the filename
  token ``-BF0_`` / ``-GFP`` / ``-RFP``, the z slice ``_000_`` / ``_001_`` /
  ``_002_``;
* per (position, z), files sorted by the composite key: the last
  ``-``-field with ``.tif`` stripped, then the 5th-from-last ``_``-field;
* length-T windows (overlapping, or stride T) kept only when all frames
  share the trap id, the 8 characters from "trap" in the path;
* BF per-frame min-max to [0, 1]; GFP / RFP ``clip((x - min) / max, 0, 1)``,
  dividing by max and not by (max - min), as the reference does;
* the random horizontal flip from the dataset's own seeded numpy rng, one
  uniform per item fetched, then the vertical flip of all frames.

Frames are read by the port's own TIFF reader (data/tiff.py), where the JAX
package calls ``cv2.imread(path, -1)``.  Items are float32 ``[C, T, H, W]``
in [0, 1], C in {1, 2, 3} for (no_gfp, no_rfp, all three).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from multi_stylegan_torch.data.tiff import read_tiff


def normalize_0_1(frames: np.ndarray, vmax: Optional[float] = None,
                  vmin: Optional[float] = None) -> np.ndarray:
    """Per-leading-dim min-max normalization (dataset/utils.py:4-23)."""
    t = frames.reshape(frames.shape[0], -1)
    mn = t.min(axis=1, keepdims=True) if vmin is None else np.float32(vmin)
    mx = t.max(axis=1, keepdims=True) if vmax is None else np.float32(vmax)
    return ((t - mn) / (mx - mn)).reshape(frames.shape)


def _imread(path: str) -> np.ndarray:
    return read_tiff(path).astype(np.float32)


def _sort_key(path: str) -> str:
    return path.split("-")[-1].split("_")[-1].replace(".tif", "") + path.split("_")[-5]


def _trap_id(path: str) -> str:
    i = path.find("trap")
    return path[i: i + 8]


class TLFMDataset:
    """Index-based dataset of [C, T, H, W] sequences."""

    def __init__(
        self,
        path: str,
        sequence_length: int = 3,
        overlap: bool = True,
        z_position_indications: Sequence[str] = ("_000_", "_001_", "_002_"),
        gfp_min: float = 150.0,
        gfp_max: float = 2200.0,
        rfp_min: float = 20.0,
        rfp_max: float = 2000.0,
        flip: bool = True,
        random_horizontal_flip: float = 0.5,
        positions: Optional[Sequence[str]] = None,
        no_rfp: bool = False,
        no_gfp: bool = False,
        seed: int = 0,
    ) -> None:
        self.sequence_length = sequence_length
        self.gfp_min, self.gfp_max = gfp_min, gfp_max
        self.rfp_min, self.rfp_max = rfp_min, rfp_max
        self.flip = flip
        self.random_horizontal_flip = random_horizontal_flip
        self.no_rfp, self.no_gfp = no_rfp, no_gfp
        # the flip draws; a loader worker process reseeds its copy
        # (data/pipeline.py)
        self.rng = np.random.default_rng(seed)

        self.samples: List[Tuple[Tuple[str, ...], ...]] = []
        for position_folder in sorted(os.listdir(path)):
            if positions is not None and position_folder not in positions:
                continue
            folder = os.path.join(path, position_folder)
            if not os.path.isdir(folder):
                continue
            all_images = [os.path.join(folder, f) for f in os.listdir(folder) if "tif" in f]
            by_channel = {
                "bf": [p for p in all_images if "-BF0_" in p],
                "gfp": [p for p in all_images if "-GFP" in p],
                "rfp": [p for p in all_images if "-RFP" in p],
            }
            for z in z_position_indications:
                zs = {ch: sorted([p for p in paths if z in p], key=_sort_key)
                      for ch, paths in by_channel.items()}
                n = len(zs["bf"])
                step = 1 if overlap else sequence_length
                for i in range(0, n - sequence_length + 1, step):
                    window = zs["bf"][i: i + sequence_length]
                    traps = [_trap_id(p) for p in window]
                    if all(t == traps[0] for t in traps):
                        self.samples.append((
                            tuple(window),
                            tuple(zs["gfp"][i: i + sequence_length]),
                            tuple(zs["rfp"][i: i + sequence_length]),
                        ))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, item: int) -> np.ndarray:
        bf_paths, gfp_paths, rfp_paths = self.samples[item]
        channels = [np.stack([_imread(p) for p in bf_paths])]
        if not self.no_gfp:
            channels.append(np.stack([_imread(p) for p in gfp_paths]))
        if not self.no_rfp:
            channels.append(np.stack([_imread(p) for p in rfp_paths]))
        images = np.stack(channels)  # [C, T, H, W]
        if self.random_horizontal_flip > 0 and self.rng.uniform() < self.random_horizontal_flip:
            images = images[..., ::-1]
        images = images.copy()
        images[0] = normalize_0_1(images[0])
        idx = 1
        if not self.no_gfp:
            images[idx] = np.clip(
                np.clip(images[idx] - self.gfp_min, 0.0, None) / self.gfp_max, None, 1.0)
            idx += 1
        if not self.no_rfp:
            images[idx] = np.clip(
                np.clip(images[idx] - self.rfp_min, 0.0, None) / self.rfp_max, None, 1.0)
        if self.flip:
            images = images[..., ::-1, :]
        return np.ascontiguousarray(images, dtype=np.float32)


def write_tlfm_tree(root: str, n_traps: int = 2, n_times: int = 4, size: int = 32,
                    channels: Sequence[str] = ("BF0", "GFP", "RFP"), seed: int = 0,
                    position: str = "Pos0") -> str:
    """A TLFM-style tree of random 16-bit uncompressed TIFFs under
    ``root/position``, named as the reference's parser expects
    (``exp-{channel}_00{z}_{time:04d}_s_x_y_stack-trap{trap:04d}.tif``: the
    sort key is then trap-major, time-minor).  Returns ``root``."""
    from multi_stylegan_torch.data.tiff import write_tiff

    ranges = {"BF0": (3000, 12000), "GFP": (100, 2500), "RFP": (10, 2100)}
    folder = os.path.join(root, position)
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for trap in range(1, n_traps + 1):
        for t in range(n_times):
            for z in range(3):
                for ch in channels:
                    lo, hi = ranges[ch]
                    img = rng.integers(lo, hi, size=(size, size)).astype(np.uint16)
                    write_tiff(os.path.join(
                        folder, f"exp-{ch}_00{z}_{t:04d}_s_x_y_stack-trap{trap:04d}.tif"), img)
    return root
