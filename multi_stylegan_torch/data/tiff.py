"""Baseline TIFF reading and writing with numpy and zlib only.

The JAX package reads the TLFM frames with ``cv2.imread(path, -1)``
(data/tlfm.py:42-48); the port reads them itself, so that it needs neither
OpenCV, PIL nor tifffile.  :func:`read_tiff` returns what ``cv2.imread(path,
-1)`` returns for the files the microscope and ``cv2.imwrite`` write: one
grey sample per pixel, 8 or 16 bits unsigned, little- or big-endian, in
strips, compressed with

* none (1),
* deflate (8, and the older code 32946),
* LZW (5, TIFF's variant: MSB-first codes, the width growing one code early),

with or without horizontal differencing (predictor 2, which ``cv2.imwrite``
sets by default).  Anything else raises ``ValueError`` naming the tag values;
there is no fallback to another library.  :func:`write_tiff` writes the
uncompressed form (for tests and fixtures).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

# tag numbers (TIFF 6.0, section 8)
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = 273, 277, 278, 279
PLANAR, PREDICTOR, TILE_WIDTH, SAMPLE_FORMAT = 284, 317, 322, 339

# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8)}

_NONE, _LZW, _DEFLATE, _DEFLATE_OLD = 1, 5, 8, 32946


def _read_ifd(data: bytes, order: str, offset: int) -> Dict[int, List]:
    (count,) = struct.unpack_from(order + "H", data, offset)
    tags = {}
    for i in range(count):
        tag, kind, n = struct.unpack_from(order + "HHI", data, offset + 2 + 12 * i)
        if kind not in _TYPES:
            continue  # a type this reader never needs (e.g. BigTIFF's LONG8)
        code, size = _TYPES[kind]
        at = offset + 2 + 12 * i + 8
        if n * size > 4:
            (at,) = struct.unpack_from(order + "I", data, at)
        tags[tag] = list(struct.unpack_from(order + code * n, data, at))
    return tags


def lzw_decode(data: bytes) -> bytes:
    """Decode one TIFF LZW strip (TIFF 6.0 section 13)."""
    src = bytes(data) + b"\0\0\0"
    n_bits = 8 * len(data)
    out = bytearray()
    table: List[bytes] = []
    width, pos, prev = 9, 0, None
    while pos + width <= n_bits:
        i = pos >> 3
        word = (src[i] << 16) | (src[i + 1] << 8) | src[i + 2]
        code = (word >> (24 - (pos & 7) - width)) & ((1 << width) - 1)
        pos += width
        if code == 257:  # end of information
            break
        if code == 256:  # clear
            table = [bytes((v,)) for v in range(256)] + [b"", b""]
            width, prev = 9, None
            continue
        if not table:
            raise ValueError("LZW strip does not start with a clear code")
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"LZW code {code} beyond the table ({len(table)} entries)")
            # the encoder widens one code early (libtiff's "early change")
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
        out += entry
        prev = entry
    return bytes(out)


def read_tiff(path: str) -> np.ndarray:
    """The first image of a baseline grey TIFF as an [H, W] uint8 / uint16
    array, as ``cv2.imread(path, -1)`` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] not in (b"II*\0", b"MM\0*"):
        raise ValueError(f"{path}: not a classic TIFF (header {data[:4]!r})")
    order = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(order + "I", data, 4)
    tags = _read_ifd(data, order, ifd)

    def one(tag, default=None):
        if tag not in tags:
            if default is None:
                raise ValueError(f"{path}: required tag {tag} missing")
            return default
        return tags[tag][0]

    width, height = one(WIDTH), one(LENGTH)
    bits = tags.get(BITS, [1])
    samples = one(SAMPLES, 1)
    compression = one(COMPRESSION, _NONE)
    predictor = one(PREDICTOR, 1)
    fmt = one(SAMPLE_FORMAT, 1)
    photometric = one(PHOTOMETRIC, 1)
    if (samples != 1 or len(set(bits)) != 1 or bits[0] not in (8, 16) or fmt != 1
            or photometric != 1 or TILE_WIDTH in tags or one(PLANAR, 1) != 1):
        raise ValueError(
            f"{path}: unsupported layout (SamplesPerPixel={samples}, BitsPerSample={bits}, "
            f"SampleFormat={fmt}, Photometric={photometric}, tiled={TILE_WIDTH in tags}, "
            f"PlanarConfiguration={one(PLANAR, 1)}): only one unsigned 8/16-bit grey "
            "sample per pixel in strips is read")
    if compression not in (_NONE, _LZW, _DEFLATE, _DEFLATE_OLD) or predictor not in (1, 2):
        raise ValueError(f"{path}: unsupported Compression={compression} / Predictor="
                         f"{predictor} (read: 1, 5, 8, 32946; predictor 1 or 2)")
    dtype = np.dtype(np.uint8 if bits[0] == 8 else order + "u2")
    rows_per_strip = min(one(ROWS_PER_STRIP, height), height)
    offsets, counts = tags[STRIP_OFFSETS], tags[STRIP_BYTES]
    row_bytes = width * dtype.itemsize
    strips = []
    for k, (off, count) in enumerate(zip(offsets, counts)):
        raw = data[off:off + count]
        if compression == _LZW:
            raw = lzw_decode(raw)
        elif compression in (_DEFLATE, _DEFLATE_OLD):
            raw = zlib.decompress(raw)
        rows = min(rows_per_strip, height - k * rows_per_strip)
        if len(raw) < rows * row_bytes:
            raise ValueError(f"{path}: strip {k} holds {len(raw)} bytes, needs {rows * row_bytes}")
        strips.append(np.frombuffer(raw[:rows * row_bytes], dtype).reshape(rows, width))
    image = np.concatenate(strips).astype(dtype.newbyteorder("="))
    if image.shape != (height, width):
        raise ValueError(f"{path}: strips give {image.shape}, the header {(height, width)}")
    if predictor == 2:  # horizontal differencing, modulo 2^bits
        image = np.cumsum(image, axis=1, dtype=image.dtype)
    return image


def write_tiff(path: str, image: np.ndarray) -> None:
    """Write an [H, W] uint8 / uint16 array as an uncompressed little-endian
    grey TIFF in one strip."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"expected [H, W] uint8 or uint16, got {image.dtype} {image.shape}")
    h, w = image.shape
    pixels = image.astype(image.dtype.newbyteorder("<")).tobytes()
    entries = [(WIDTH, 4, w), (LENGTH, 4, h), (BITS, 3, 8 * image.dtype.itemsize),
               (COMPRESSION, 3, _NONE), (PHOTOMETRIC, 3, 1), (STRIP_OFFSETS, 4, 0),
               (SAMPLES, 3, 1), (ROWS_PER_STRIP, 4, h), (STRIP_BYTES, 4, len(pixels))]
    ifd_size = 2 + 12 * len(entries) + 4
    pixel_offset = 8 + ifd_size
    ifd = struct.pack("<H", len(entries))
    for tag, kind, value in entries:
        value = pixel_offset if tag == STRIP_OFFSETS else value
        packed = struct.pack("<H", value) + b"\0\0" if kind == 3 else struct.pack("<I", value)
        ifd += struct.pack("<HHI", tag, kind, 1) + packed
    ifd += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8) + ifd + pixels)
