"""Sample strips as PNG files, and animated GIFs, written with zlib, struct
and numpy only (no imaging library).

Same file names and tints as the JAX package's ``Logger.save_prediction``
(reference misc.py:132-166): per sample and domain a horizontal strip of the
T frames, BF grey, GFP green, RFP red, ``{name}_{suffix}_{batch_index}.png``.

The GIF writer serves the interpolation CLI, whose frames hold only grey
(v, v, v) and green (0, v, 0) tones: its fixed palette is 128 grey and 128
green levels, so every pixel of such a frame lands within one palette step
(255 / 127 levels) of its value.
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


# 128 grey levels, then 128 green levels: round(i * 255 / 127), i < 128
_LEVELS = np.round(np.arange(128) * 255.0 / 127.0).astype(np.uint8)
GIF_PALETTE = np.concatenate([np.stack([_LEVELS] * 3, axis=1),
                              np.stack([0 * _LEVELS, _LEVELS, 0 * _LEVELS], axis=1)])


def gif_indices(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [H, W] indices into :data:`GIF_PALETTE`: a pixel
    with red and blue 0 and green above is green, any other grey, at the
    nearest of 128 levels of its green value."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.dtype} {rgb.shape}")
    g = rgb[..., 1].astype(np.int32)
    green = (rgb[..., 0] == 0) & (rgb[..., 2] == 0) & (g > 0)
    return ((g * 127 + 127) // 255 + 128 * green).astype(np.uint8)


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a flat index array (codes packed LSB
    first), with a clear code at the start and whenever the 12-bit table is
    full, as giflib writes it.  The code table is a dict; the bit packing
    is numpy."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    data = np.asarray(indices, np.uint8).reshape(-1).tolist()
    codes, widths = [clear], [min_code_size + 1]
    table, next_code, width = {}, end + 1, min_code_size + 1
    prefix = data[0]
    for byte in data[1:]:
        key = prefix << 8 | byte
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code >= (1 << width) and width < 12:
            width += 1
        if next_code >= 4095:
            codes.append(clear)
            widths.append(width)
            table, next_code, width = {}, end + 1, min_code_size + 1
        else:
            table[key] = next_code
            next_code += 1
        prefix = byte
    codes += [prefix, end]
    widths += [width, width]
    c, w = np.asarray(codes, np.uint32), np.asarray(widths)
    bits = ((c[:, None] >> np.arange(12, dtype=np.uint32)) & 1).astype(np.uint8)
    return np.packbits(bits[np.arange(12)[None, :] < w[:, None]], bitorder="little").tobytes()


def encode_gif(frames, fps: float) -> bytes:
    """[H, W] palette-index frames (:func:`gif_indices`) -> an endlessly
    looping GIF89a at ``fps`` (the delay is whole hundredths of a second)."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape
    delay = max(1, round(100.0 / fps))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), GIF_PALETTE.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f in frames:
        if f.shape != (h, w):
            raise ValueError(f"frame of shape {f.shape}, the first is {(h, w)}")
        data = lzw_encode(f)
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08"]
        out += [bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)]
        out.append(b"\x00")
    out.append(b"\x3b")
    return b"".join(out)


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
