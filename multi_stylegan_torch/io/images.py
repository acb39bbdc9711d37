"""Sample strips as PNG files, written with zlib and struct only.

Same file names and tints as the JAX package's ``Logger.save_prediction``
(reference misc.py:132-166): per sample and domain a horizontal strip of the
T frames, BF grey, GFP green, RFP red, ``{name}_{suffix}_{batch_index}.png``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

TINTS = (
    ("bf", (1.0, 1.0, 1.0)),
    ("gfp", (0.0, 1.0, 0.0)),
    ("rfp", (1.0, 0.0, 0.0)),
)


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (8-bit RGB, no filtering, no interlace)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_prediction(prediction: np.ndarray, directory: str, name: str) -> list:
    """Save [B, domains, T, H, W] predictions as per-sample frame strips;
    returns the paths written."""
    pred = np.asarray(prediction)
    paths = []
    for batch_index in range(pred.shape[0]):
        for domain in range(min(pred.shape[1], len(TINTS))):
            suffix, tint = TINTS[domain]
            strip = np.concatenate(list(pred[batch_index, domain]), axis=1)  # [H, T*W]
            rgb = np.stack([strip * t for t in tint], axis=-1)
            rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
            path = os.path.join(directory, f"{name}_{suffix}_{batch_index}.png")
            with open(path, "wb") as f:
                f.write(encode_png(rgb))
            paths.append(path)
    return paths
