"""The PyTorch port's data path against OpenCV and the JAX package (CPU).

TIFF frames: the port's reader equals ``cv2.imread(path, -1)`` on what
``cv2.imwrite`` writes (its default LZW with predictor 2, and uncompressed,
deflate and old-style deflate through ``IMWRITE_TIFF_COMPRESSION``).  The
dataset, the loader's batches and the trap map equal the JAX package's
exactly for the same tree and seed.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from multi_stylegan_tpu.data import BatchLoader, SyntheticTLFMDataset
from multi_stylegan_tpu.data import TLFMDataset as JaxTLFMDataset
from multi_stylegan_tpu.data import make_trap_weights_map as jax_trap_map
from multi_stylegan_torch.data import tiff
from multi_stylegan_torch.data.pipeline import load_loader_state, loader_state, make_loader
from multi_stylegan_torch.data.synthetic import SyntheticTLFMDataset as PortSynthetic
from multi_stylegan_torch.data.tlfm import TLFMDataset, write_tlfm_tree
from multi_stylegan_torch.data.trap_weights import make_trap_weights_map

cv2 = pytest.importorskip("cv2")

# cv2.imwrite's default for 16-bit grey is LZW (5) with predictor 2
COMPRESSIONS = {"default LZW": None, "none": 1, "deflate": 8, "old deflate": 32946}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tags(path):
    with open(path, "rb") as f:
        data = f.read()
    order = "<" if data[:2] == b"II" else ">"
    return tiff._read_ifd(data, order, struct.unpack_from(order + "I", data, 4)[0])


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("compression", list(COMPRESSIONS))
def test_reader_equals_cv2(tmp_path, compression, dtype):
    rng = np.random.default_rng(0)
    hi = 12000 if dtype == np.uint16 else 256
    # noise (long LZW codes, deep tables) and a ramp (long runs, many strips)
    images = [rng.integers(0, hi, size=(37, 53)).astype(dtype),
              (np.add.outer(np.arange(96), np.arange(80)) * 37 % hi).astype(dtype)]
    code = COMPRESSIONS[compression]
    params = [] if code is None else [cv2.IMWRITE_TIFF_COMPRESSION, code]
    for i, img in enumerate(images):
        path = str(tmp_path / f"img{i}.tif")
        assert cv2.imwrite(path, img, params)
        tags = _tags(path)
        assert tags[tiff.COMPRESSION] == [5 if code is None else code]
        if code != 1:
            assert tags[tiff.PREDICTOR] == [2]  # what makes cv2's files hard
        ref = cv2.imread(path, -1)
        got = tiff.read_tiff(path)
        assert got.dtype == ref.dtype == dtype
        np.testing.assert_array_equal(got, ref)


def _big_endian_tiff(path, img, compression, predictor):
    """A big-endian grey TIFF in two strips, written by hand (cv2 writes
    little-endian only)."""
    h, w = img.shape
    rows = (h + 1) // 2
    body = img.astype(">u2")
    if predictor == 2:
        body = np.diff(body.astype(np.int64), axis=1, prepend=0).astype(">u2")
    strips = [body[:rows].tobytes(), body[rows:].tobytes()]
    if compression == 8:
        strips = [zlib.compress(s) for s in strips]
    offsets, at = [], 8
    for s in strips:
        offsets.append(at)
        at += len(s)
    entries = [(256, 3, [w]), (257, 3, [h]), (258, 3, [16]), (259, 3, [compression]),
               (262, 3, [1]), (273, 4, offsets), (277, 3, [1]), (278, 3, [rows]),
               (279, 4, [len(s) for s in strips]), (317, 3, [predictor])]
    extra_at = at + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack(">H", len(entries)), b""
    for tag, kind, vals in entries:
        code = "H" if kind == 3 else "I"
        packed = struct.pack(">" + code * len(vals), *vals)
        if len(packed) <= 4:
            ifd += struct.pack(">HHI", tag, kind, len(vals)) + packed.ljust(4, b"\0")
        else:
            ifd += struct.pack(">HHII", tag, kind, len(vals), extra_at + len(extra))
            extra += packed
    with open(path, "wb") as f:
        f.write(b"MM\0*" + struct.pack(">I", at) + b"".join(strips) + ifd
                + struct.pack(">I", 0) + extra)


@pytest.mark.parametrize("compression,predictor", [(1, 1), (8, 2)])
def test_reader_big_endian_strips(tmp_path, compression, predictor):
    img = np.random.default_rng(1).integers(0, 65535, size=(9, 13)).astype(np.uint16)
    path = str(tmp_path / "be.tif")
    _big_endian_tiff(path, img, compression, predictor)
    np.testing.assert_array_equal(tiff.read_tiff(path), img)
    np.testing.assert_array_equal(cv2.imread(path, -1), img)


def test_writer_round_trips_through_cv2_and_unsupported_files_raise(tmp_path):
    rng = np.random.default_rng(2)
    for dtype, hi in ((np.uint16, 65535), (np.uint8, 255)):
        img = rng.integers(0, hi, size=(31, 17)).astype(dtype)
        path = str(tmp_path / f"w_{np.dtype(dtype).name}.tif")
        tiff.write_tiff(path, img)
        np.testing.assert_array_equal(cv2.imread(path, -1), img)
        np.testing.assert_array_equal(tiff.read_tiff(path), img)
    # JPEG compression (7) and an RGB file: refused with the tag values
    jpeg = str(tmp_path / "jpeg.tif")
    data = bytearray(open(path, "rb").read())
    data[data.index(struct.pack("<HHI", 259, 3, 1)) + 8] = 7
    open(jpeg, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="Compression=7"):
        tiff.read_tiff(jpeg)
    rgb = str(tmp_path / "rgb.tif")
    cv2.imwrite(rgb, rng.integers(0, 255, size=(8, 8, 3)).astype(np.uint8))
    with pytest.raises(ValueError, match="SamplesPerPixel=3"):
        tiff.read_tiff(rgb)
    png = str(tmp_path / "x.png")
    cv2.imwrite(png, np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="not a classic TIFF"):
        tiff.read_tiff(png)


# ------------------------------------------------------------------ dataset


@pytest.fixture(scope="module")
def cv2_tree(tmp_path_factory):
    """2 traps x 5 timesteps x 3 z x {BF, GFP, RFP}, 16-bit, written by
    cv2.imwrite (LZW + predictor), names as tests/test_data.py."""
    root = tmp_path_factory.mktemp("tlfm_cv2")
    rng = np.random.default_rng(0)
    for pos in ("Pos0", "Pos1"):
        (root / pos).mkdir()
        for trap in (1, 2):
            for t in range(5 if pos == "Pos0" else 4):
                for z in range(3):
                    for ch, lo, hi in (("BF0", 3000, 12000), ("GFP", 100, 2500),
                                       ("RFP", 10, 2100)):
                        img = rng.integers(lo, hi, size=(16, 24)).astype(np.uint16)
                        cv2.imwrite(str(root / pos / f"exp-{ch}_00{z}_{t:04d}_s_x_y_stack-"
                                                      f"trap{trap:04d}.tif"), img)
    (root / "notes.txt").write_text("not a position folder")
    return str(root)


@pytest.mark.parametrize("kw", [dict(), dict(no_rfp=True), dict(no_gfp=True, no_rfp=True),
                                dict(overlap=False, no_rfp=True), dict(positions=["Pos1"]),
                                dict(seed=5, random_horizontal_flip=0.7, flip=False)],
                         ids=["all", "no_rfp", "bf_only", "no_overlap", "positions", "seed"])
def test_tlfm_dataset_equals_jax(cv2_tree, kw):
    port, ref = TLFMDataset(cv2_tree, **kw), JaxTLFMDataset(cv2_tree, **kw)
    assert len(port) == len(ref) > 0
    assert port.samples == ref.samples
    for i in list(range(len(ref))) + [0, 3]:  # the flips follow each dataset's rng
        a, b = port[i], ref[i]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_tlfm_same_trap_windows(cv2_tree):
    ds = TLFMDataset(cv2_tree, no_rfp=True)
    # Pos0: per (z, trap) 5 frames -> 3 windows; Pos1: 4 -> 2; x 2 traps x 3 z
    assert len(ds) == (3 + 2) * 2 * 3
    for bf, gfp, _ in ds.samples:
        assert len({p[p.find("trap"):p.find("trap") + 8] for p in bf}) == 1
        assert [p.replace("-BF0_", "-GFP_") for p in bf] == list(gfp)


# ------------------------------------------------------------------- loader


def test_loader_batches_equal_the_jax_batch_loader(cv2_tree):
    port_ds, ref_ds = TLFMDataset(cv2_tree, no_rfp=True), JaxTLFMDataset(cv2_tree, no_rfp=True)
    loader = make_loader(port_ds, batch_size=4, seed=3)
    ref = BatchLoader(ref_ds, batch_size=4, seed=3, num_workers=1)
    assert len(loader) == len(ref) == 7  # 30 sequences, the last 2 dropped
    for epoch in range(2):
        got, want = list(loader), list(ref)
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b)


def test_loader_state_replays_the_next_epoch(cv2_tree):
    loader = make_loader(TLFMDataset(cv2_tree, no_rfp=True), batch_size=4, seed=1)
    list(loader)
    state = loader_state(loader)
    nxt = [b.clone() for b in loader]
    fresh = make_loader(TLFMDataset(cv2_tree, no_rfp=True), batch_size=4, seed=1)
    load_loader_state(fresh, state)
    for a, b in zip(fresh, nxt):
        assert torch.equal(a, b)


def test_loader_worker_processes_keep_the_order():
    """Two spawned workers give the in-process loader's batches (the
    synthetic fixture has no flips) and the JAX loader's."""
    port_ds = PortSynthetic(n_samples=10, resolution=(8, 8))
    ref = BatchLoader(SyntheticTLFMDataset(n_samples=10, resolution=(8, 8)), batch_size=3,
                      seed=4, num_workers=1)
    workers = make_loader(port_ds, batch_size=3, seed=4, num_workers=2)
    for _ in range(2):
        got = list(workers)
        want = list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)


def test_loader_refuses_a_dataset_smaller_than_a_batch():
    with pytest.raises(ValueError, match="cannot fill a batch"):
        make_loader(PortSynthetic(n_samples=2, resolution=(8, 8)), batch_size=4)


def test_write_tlfm_tree_is_read_by_both_datasets(tmp_path):
    root = write_tlfm_tree(str(tmp_path / "tree"), n_traps=1, n_times=5, size=8)
    assert len(os.listdir(os.path.join(root, "Pos0"))) == 5 * 3 * 3
    port, ref = TLFMDataset(root, no_rfp=True), JaxTLFMDataset(root, no_rfp=True)
    assert len(port) == len(ref) == 3 * 3
    np.testing.assert_array_equal(port[2], ref[2])


# --------------------------------------------------------------- trap map


@pytest.mark.parametrize("kw", [dict(), dict(resolution=(64, 48), inside_weight=3.0),
                                dict(resolution=(32, 32), center=(10.0, 20.5),
                                     trap_fraction=1.0, taper_fraction=0.0)])
def test_trap_map_equals_jax(kw):
    got, want = make_trap_weights_map(**kw), jax_trap_map(**kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(trap_fraction=0.0), dict(trap_fraction=1.5),
                                dict(inside_weight=-1.0), dict(outside_weight=0.0)])
def test_trap_map_errors_equal_jax(kw):
    with pytest.raises(ValueError) as ours:
        make_trap_weights_map(**kw)
    with pytest.raises(ValueError) as theirs:
        jax_trap_map(**kw)
    assert str(ours.value) == str(theirs.value)
