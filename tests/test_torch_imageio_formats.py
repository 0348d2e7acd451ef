"""The image files the port's readers took on after the TIFF slice, to the
bit as the JAX package reads them through PIL, on the CPU: the rest of
TIFF (orientation 2-8, fill order 2, BigTIFF, CCITT RLE / Group 3 / Group
4, JPEG-compressed strips and tiles, LZMA, YCbCr through libtiff's conversion,
old-style LZW, 12-bit, 16-bit planar configuration 2, LAB), progressive
JPEG that libjpeg block-smooths, TGA, SGI, PCX, PIL's identification
order, DDS (uncompressed, BC1-BC5 and BC7; BC6H in
tests/test_torch_imageio_anim.py), PSD, ICO and CUR, QOI, IM, Sun
raster, MSP, XBM, XPM, SPIDER and WebP (lossless, and lossy with its
alpha), and ``save_gray`` to TGA, SGI, PCX, DDS and IM.

Files are written at test time from seeded arrays: by PIL where PIL writes
the variant, by ``tests/torch_imagefiles.py`` elsewhere.  Bounds, every
case: the port's ``load_gray`` and ``load_depth`` equal the JAX package's
to the bit (or both raise), the library's samples, mode and palette equal
its plain twin's, the mode is PIL's; refused files raise a ``ValueError``
naming the file and the feature; ``save_gray``'s files equal PIL's bytes.
The TGA folder of ``test_data/torch_io`` reads frame for frame as the JAX
package reads it and as the PNG frames it was cut from.
"""
import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from srrg2_proslam_tpu.io import datasets as jds

from srrg2_proslam_tpu_torch.io import datasets as tds
from srrg2_proslam_tpu_torch.io import images, images_plain
import torch_imagefiles as tf

REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
FIXTURES = os.path.join(REPO, "test_data", "torch_io")
H, W = 21, 37
REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _write(tmp_path, name: str, blob: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def assert_reads_as_jax(path: str):
    """Library == twin (samples, mode, palette), mode == PIL's, and the
    port's load_gray / load_depth == the JAX package's (or both raise)."""
    mode = Image.open(path).mode
    lib, plain = images.decode(path), images_plain.decode(path)
    assert lib.mode == plain.mode == mode
    assert lib.samples.dtype == plain.samples.dtype and lib.samples.shape == plain.samples.shape
    np.testing.assert_array_equal(lib.samples, plain.samples)
    if lib.mode == "P":
        np.testing.assert_array_equal(lib.palette, plain.palette)
    for name in ("load_gray", "load_depth"):
        try:
            want = getattr(jds, name)(path)
        except ValueError:
            with pytest.raises(ValueError) as err:
                getattr(tds, name)(path)
            assert path in str(err.value)
            continue
        got = getattr(tds, name)(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return lib


def samples(seed: int, n: int, bits: int, h: int = H, w: int = W):
    return np.random.default_rng(seed).integers(0, 1 << bits, (h, w, n), dtype=np.int64)


def smooth(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """A smooth pattern with noise, uint8 [h, w, c] (JPEG-friendly)."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(xx / (7 + k) + yy / (5 + 2 * k)) for k in range(c)], -1)
    noise = np.random.default_rng(seed).normal(0, 12, (h, w, c))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _pil_bytes(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# ---- TIFF orientation ------------------------------------------------------------

TRANSPOSE = {1: lambda a: a, 2: np.fliplr, 3: lambda a: np.rot90(a, 2), 4: np.flipud,
             5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, 3),
             7: lambda a: np.rot90(a, 2).transpose(1, 0, 2), 8: np.rot90}


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("compression", [1, 5])
def test_tiff_orientation_transposes_as_pil(tmp_path, orientation, compression):
    s = samples(orientation, 1, 8)
    path = _write(tmp_path, "o.tif", tf.tiff_bytes(s, 8, 1, compression=compression,
                                                   rows_per_strip=7,
                                                   tags=[(274, 3, [orientation])]))
    lib = assert_reads_as_jax(path)
    np.testing.assert_array_equal(lib.samples, TRANSPOSE[orientation](s.astype(np.uint8)))


@pytest.mark.parametrize("orientation,kw", [
    (6, dict(photometric=2, n=3, bits=8, compression=5, tile=(16, 16))),
    (7, dict(photometric=1, n=1, bits=16, compression=8, big_endian=True)),
    (5, dict(photometric=3, n=1, bits=4, compression=32773)),
], ids=["rgb-tiles-6", "u16-be-7", "palette4-5"])
def test_tiff_orientation_other_layouts(tmp_path, orientation, kw):
    kw = dict(kw)
    photo, n, bits = kw.pop("photometric"), kw.pop("n"), kw.pop("bits")
    if photo == 3:
        kw["colormap"] = np.random.default_rng(3).integers(0, 65536, (3, 16))
    s = samples(orientation + 10, n, bits)
    path = _write(tmp_path, "o.tif", tf.tiff_bytes(s, bits, photo, tags=[(274, 3, [orientation])],
                                                   **kw))
    lib = assert_reads_as_jax(path)
    assert lib.samples.shape[:2] == (W, H)


def test_orientation_6_kitti_folder_reads_transposed_through_both_packages(tmp_path):
    """The folder readers pass a transposed frame on as it is."""
    for sub in ("image_0", "image_1"):
        (tmp_path / sub).mkdir()
        for i in (0, 1):
            gray = smooth(24, 40, 1, i)[:, :, 0]
            Image.fromarray(gray).save(str(tmp_path / sub / f"{i:06d}.tif"),
                                       compression="tiff_lzw", tiffinfo={274: 6})
    (tmp_path / "times.txt").write_text("0.0\n0.1\n")
    got, want = list(tds.iter_kitti_odometry(str(tmp_path))), list(
        jds.iter_kitti_odometry(str(tmp_path)))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.left.shape == (40, 24)
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)


# ---- TIFF fill order 2, BigTIFF, old-style LZW ---------------------------------------

def _fill2(s, bits, photo, compression, big_endian=False, **kw):
    """A fill-order-2 TIFF: each stored (compressed) byte bit-reversed."""
    coder = {1: bytes, 5: tf.lzw_tiff, 8: lambda d: zlib.compress(d, 6),
             32773: tf.packbits}[compression]
    h = s.shape[0]
    chunks = [coder(tf._tiff_rows(s[y:y + 8], bits, ">" if big_endian else "<", 1).tobytes())
              .translate(REVERSE) for y in range(0, h, 8)]
    entries = [(258, 3, [bits] * s.shape[2]), (259, 3, [compression]), (262, 3, [photo]),
               (266, 3, [2]), (277, 3, [s.shape[2]])] + list(kw.get("tags", []))
    return tf.tiff_chunks_bytes(s.shape[1], h, chunks, entries, big_endian=big_endian,
                                rows_per_strip=8)


FILL2 = [("bilevel", 1, 1, 1, 1, False), ("gray4-miniswhite", 4, 0, 1, 5, True),
         ("gray8", 8, 1, 1, 8, False), ("u16", 16, 1, 1, 32773, False),
         ("rgb", 8, 2, 3, 5, True), ("palette8", 8, 3, 1, 1, True)]


@pytest.mark.parametrize("name,bits,photo,n,compression,be", FILL2, ids=[c[0] for c in FILL2])
def test_tiff_fill_order_2_reads_as_jax(tmp_path, name, bits, photo, n, compression, be):
    tags = []
    if photo == 3:
        cmap = np.random.default_rng(4).integers(0, 65536, (3, 256)).reshape(-1)
        tags = [(320, 3, list(cmap))]
    path = _write(tmp_path, "f.tif", _fill2(samples(len(name), n, bits), bits, photo,
                                            compression, be, tags=tags))
    assert_reads_as_jax(path)


@pytest.mark.parametrize("mode,compression", [("L", "raw"), ("RGB", "tiff_lzw"),
                                              ("I;16", "tiff_adobe_deflate")])
def test_bigtiff_written_by_pil_reads_as_jax(tmp_path, mode, compression):
    rng = np.random.default_rng(len(mode))
    arr = (rng.integers(0, 65536, (H, W)).astype(np.uint16) if mode == "I;16"
           else rng.integers(0, 256, (H, W, 3) if mode == "RGB" else (H, W)).astype(np.uint8))
    path = _write(tmp_path, "b.tif", _pil_bytes(Image.fromarray(arr), "TIFF", big_tiff=True,
                                                compression=compression, tiffinfo={278: 5}))
    assert_reads_as_jax(path)


def test_bigtiff_tiles_read_as_jax_and_big_endian_is_refused(tmp_path):
    """PIL tells BigTIFF by the third byte, so it reads no big-endian one."""
    s = samples(5, 3, 8, 40, 50)
    tiles = []
    pad = np.zeros((48, 64, 3), np.int64)
    pad[:40, :50] = s
    for y in range(0, 40, 16):
        for x in range(0, 50, 16):
            tiles.append(tf.lzw_tiff(pad[y:y + 16, x:x + 16].astype(np.uint8).tobytes()))
    for be in (False, True):
        path = _write(tmp_path, f"b{be}.tif", tf.tiff_chunks_bytes(
            50, 40, tiles, [(258, 3, [8, 8, 8]), (259, 3, [5]), (262, 3, [2]), (277, 3, [3])],
            big_endian=be, tile=(16, 16), bigtiff=True))
        if not be:
            assert_reads_as_jax(path)
            continue
        with pytest.raises(OSError):
            Image.open(path).load()
        for read in (tds.load_gray, images_plain.decode):
            with pytest.raises(ValueError, match="big-endian BigTIFF") as err:
                read(path)
            assert path in str(err.value)


@pytest.mark.parametrize("shape,levels", [((21, 37), 256), ((64, 200), 256), ((120, 300), 8)])
def test_old_style_lzw_reads_as_jax(tmp_path, shape, levels):
    raw = np.random.default_rng(shape[1]).integers(0, levels, shape).astype(np.uint8)
    path = _write(tmp_path, "l.tif", tf.tiff_chunks_bytes(
        shape[1], shape[0], [tf.lzw_tiff_compat(raw.tobytes())],
        [(258, 3, [8]), (259, 3, [5]), (262, 3, [1])]))
    assert_reads_as_jax(path)


@pytest.mark.parametrize("mode,info", [("L", {}), ("RGB", {317: 2}), ("I;16", {278: 7}),
                                       ("RGBA", {}), ("1", {278: 5}), ("P", {})],
                         ids=["L", "rgb-predictor", "u16-strips", "rgba", "bilevel", "palette"])
def test_lzma_tiff_written_by_pil_reads_as_jax(tmp_path, mode, info):
    """libtiff's xz streams (a delta filter, then LZMA2), decoded in the repo."""
    arr = smooth(40, 56, 4, len(mode))
    img = (Image.fromarray(np.random.default_rng(1).integers(0, 65536, (40, 56)).astype(np.uint16))
           if mode == "I;16" else Image.fromarray(arr[:, :, :3]).quantize(60) if mode == "P"
           else Image.fromarray(arr[:, :, 0]).convert("1") if mode == "1"
           else Image.fromarray(arr[:, :, 0] if mode == "L" else arr[:, :, :len(mode)], mode))
    assert_reads_as_jax(_write(tmp_path, "z.tif", _pil_bytes(img, "TIFF", compression="lzma",
                                                            tiffinfo=info)))


# ---- TIFF 12-bit, 16-bit planes, LAB -------------------------------------------------

def _pack12(values: np.ndarray) -> bytes:
    """[h, w] 12-bit values -> MSB-first rows, each padded to a byte."""
    out = b""
    for row in values:
        bits = "".join(format(int(v), "012b") for v in row)
        bits += "0" * (-len(bits) % 8)
        out += int(bits, 2).to_bytes(len(bits) // 8, "big")
    return out


@pytest.mark.parametrize("compression", [1, 5, 8])
def test_12_bit_gray_reads_as_jax(tmp_path, compression):
    data = _pack12(samples(12, 1, 12)[:, :, 0])
    coded = {1: bytes, 5: tf.lzw_tiff, 8: zlib.compress}[compression](data)
    path = _write(tmp_path, "t.tif", tf.tiff_chunks_bytes(
        W, H, [coded], [(258, 3, [12]), (259, 3, [compression]), (262, 3, [1])]))
    lib = assert_reads_as_jax(path)
    assert lib.mode == "I;16" and lib.samples.max() < 4096


PLANAR16 = [("rgb-strips", 3, 2, (), 1, False, {}), ("rgb-tiles", 3, 2, (), 1, True,
                                                      dict(tile=(16, 16))),
            ("rgb-lzw-be", 3, 2, (), 5, True, {}), ("rgba-deflate", 4, 2, (2,), 8, False, {}),
            ("cmyk", 4, 5, (), 1, False, {})]


@pytest.mark.parametrize("name,n,photo,extra,compression,be,kw", PLANAR16,
                         ids=[c[0] for c in PLANAR16])
def test_16_bit_planar_configuration_2_reads_as_jax(tmp_path, name, n, photo, extra,
                                                    compression, be, kw):
    path = _write(tmp_path, "p.tif", tf.tiff_bytes(samples(n, n, 16), 16, photo, extra=extra,
                                                   compression=compression, big_endian=be,
                                                   planar=2, **kw))
    assert_reads_as_jax(path)


@pytest.mark.parametrize("compression", [1, 5])
def test_lab_reads_as_jax_and_has_no_gray(tmp_path, compression):
    """PIL opens LAB but cannot convert it to L: load_gray raises in both
    packages, load_depth gives L."""
    path = _write(tmp_path, "lab.tif", tf.tiff_bytes(samples(8, 3, 8), 8, 8,
                                                     compression=compression))
    with pytest.raises(ValueError):
        jds.load_gray(path)
    with pytest.raises(ValueError, match="LAB") as err:
        tds.load_gray(path)
    assert path in str(err.value)
    assert assert_reads_as_jax(path).mode == "LAB"


# ---- TIFF CCITT -------------------------------------------------------------------

def _bilevel(kind: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[:40, :w]
    pats = [(xx // 7 + yy // 3) % 3 == 0, np.random.default_rng(w).random((40, w)) > 0.5,
            np.sin(xx / 40.0 + yy / 9.0) > 0.3, ((xx > 100) & (xx < w - 90)) | (yy % 7 == 0)]
    return (pats[kind] * 255).astype(np.uint8)


CCITT = [("rle", "tiff_ccitt", {}, 0, 37), ("g3-1d", "group3", {}, 1, 53),
         ("g3-2d", "group3", {292: 1}, 2, 64), ("g3-2d-aligned", "group3", {292: 5}, 0, 64),
         ("g3-1d-aligned", "group3", {292: 4}, 1, 37), ("g4", "group4", {}, 2, 53),
         ("g4-wide", "group4", {}, 3, 2700), ("g3-2d-wide", "group3", {292: 1}, 3, 2700)]


@pytest.mark.parametrize("name,compression,info,pattern,width", CCITT, ids=[c[0] for c in CCITT])
def test_ccitt_written_by_pil_reads_as_jax(tmp_path, name, compression, info, pattern, width):
    img = Image.fromarray(_bilevel(pattern, width)).convert("1")
    path = _write(tmp_path, "c.tif", _pil_bytes(img, "TIFF", compression=compression,
                                                tiffinfo=info))
    assert assert_reads_as_jax(path).mode == "1"


def _set_short(blob: bytes, tag: int, value: int) -> bytes:
    out = bytearray(blob)
    ifd = int.from_bytes(blob[4:8], "little")
    for i in range(int.from_bytes(blob[ifd:ifd + 2], "little")):
        at = ifd + 2 + 12 * i
        if int.from_bytes(blob[at:at + 2], "little") == tag:
            out[at + 8:at + 10] = value.to_bytes(2, "little")
    return bytes(out)


@pytest.mark.parametrize("compression", ["group4", "group3"])
def test_ccitt_miniswhite_and_fill_order_2_read_as_jax(tmp_path, compression):
    blob = _pil_bytes(Image.fromarray(_bilevel(0, 45)).convert("1"), "TIFF",
                      compression=compression, tiffinfo={292: 1} if compression == "group3"
                      else {})
    assert_reads_as_jax(_write(tmp_path, "w.tif", _set_short(blob, 262, 0)))
    ifd = int.from_bytes(blob[4:8], "little")
    reversed_data = blob[:8] + blob[8:ifd].translate(REVERSE) + blob[ifd:]
    n = int.from_bytes(blob[ifd:ifd + 2], "little")
    entry = struct.pack("<HHII", 266, 3, 1, 2)
    entries = sorted([reversed_data[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(n)]
                     + [entry], key=lambda e: int.from_bytes(e[:2], "little"))
    fill2 = (reversed_data[:ifd] + struct.pack("<H", n + 1) + b"".join(entries)
             + bytes(4) + reversed_data[ifd + 2 + 12 * n + 4:])
    assert_reads_as_jax(_write(tmp_path, "f.tif", fill2))


# ---- TIFF JPEG and YCbCr ------------------------------------------------------------

@pytest.mark.parametrize("mode,orientation", [("L", 1), ("RGB", 1), ("YCbCr", 1), ("RGB", 6)])
def test_jpeg_tiff_written_by_pil_reads_as_jax(tmp_path, mode, orientation):
    img = Image.fromarray(smooth(40, 56, 3, 1)).convert(mode)
    path = _write(tmp_path, "j.tif", _pil_bytes(img, "TIFF", compression="jpeg",
                                                tiffinfo={274: orientation, 278: 16}))
    assert_reads_as_jax(path)


def _jpeg_strips(arr: np.ndarray, rows: int, sub: int, tables: bool = True):
    chunks, shared = [], b""
    for y in range(0, arr.shape[0], rows):
        blob = _pil_bytes(Image.fromarray(np.ascontiguousarray(arr[y:y + rows])), "JPEG",
                          quality=85, subsampling=sub)
        if tables:
            shared, blob = tf.split_jpeg_tables(blob)
        chunks.append(blob)
    return chunks, shared


JPEG_TIFF = [("ycbcr-420-strips", 6, 2, 16, True, False), ("ycbcr-422-one-strip", 6, 1, 45, True,
                                                            True),
             ("ycbcr-444-no-tables", 6, 0, 16, False, True),
             ("rgb-photometric-no-conversion", 2, 0, 45, True, False)]


@pytest.mark.parametrize("name,photo,sub,rows,tables,be", JPEG_TIFF, ids=[c[0] for c in JPEG_TIFF])
def test_jpeg_tiff_strips_read_as_jax(tmp_path, name, photo, sub, rows, tables, be):
    arr = smooth(45, 61, 3, rows)
    chunks, shared = _jpeg_strips(arr, rows, sub, tables)
    hs, vs = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[sub]
    entries = [(258, 3, [8, 8, 8]), (259, 3, [7]), (262, 3, [photo]), (277, 3, [3]),
               (284, 3, [1]), (530, 3, [hs, vs])] + ([(347, 7, list(shared))] if tables else [])
    path = _write(tmp_path, "j.tif", tf.tiff_chunks_bytes(61, 45, chunks, entries,
                                                          big_endian=be, rows_per_strip=rows))
    assert_reads_as_jax(path)


def test_jpeg_tiff_tiles_and_gray_read_as_jax(tmp_path):
    arr = np.zeros((64, 64, 3), np.uint8)
    arr[:45, :61] = smooth(45, 61, 3, 9)
    tiles = []
    for y in range(0, 45, 32):
        for x in range(0, 61, 32):
            shared, rest = tf.split_jpeg_tables(_pil_bytes(
                Image.fromarray(np.ascontiguousarray(arr[y:y + 32, x:x + 32])), "JPEG",
                quality=80, subsampling=2))
            tiles.append(rest)
    assert_reads_as_jax(_write(tmp_path, "t.tif", tf.tiff_chunks_bytes(
        61, 45, tiles, [(258, 3, [8, 8, 8]), (259, 3, [7]), (262, 3, [6]), (277, 3, [3]),
                        (530, 3, [2, 2]), (347, 7, list(shared))], tile=(32, 32))))
    gray = smooth(45, 61, 1, 10)[:, :, 0]
    shared, rest = tf.split_jpeg_tables(_pil_bytes(Image.fromarray(gray), "JPEG", quality=90))
    for photo in (1, 0):
        assert_reads_as_jax(_write(tmp_path, f"g{photo}.tif", tf.tiff_chunks_bytes(
            61, 45, [rest], [(258, 3, [8]), (259, 3, [7]), (262, 3, [photo]),
                             (347, 7, list(shared))])))


YCBCR = [(1, 1, 5, None), (2, 1, 8, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]),
         (2, 2, 32773, None), (4, 2, 5, [(15, 2), (471, 2), (255, 2), (481, 2), (255, 2),
                                          (479, 2)]),
         (4, 4, 8, None), (4, 1, 5, [(0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1)])]


@pytest.mark.parametrize("hs,vs,compression,rbw", YCBCR,
                         ids=[f"{h}x{v}-c{c}{'-rbw' if r else ''}" for h, v, c, r in YCBCR])
def test_ycbcr_tiff_converts_as_libtiff(tmp_path, hs, vs, compression, rbw):
    rng = np.random.default_rng(hs * 10 + vs)
    h, w = 45, 61
    y = rng.integers(0, 256, (h, w))
    cb, cr = (rng.integers(0, 256, (-(-h // vs), -(-w // hs))) for _ in range(2))
    coder = {5: tf.lzw_tiff, 8: zlib.compress, 32773: tf.packbits}[compression]
    entries = [(258, 3, [8, 8, 8]), (259, 3, [compression]), (262, 3, [6]), (277, 3, [3]),
               (530, 3, [hs, vs])] + ([(532, 5, rbw)] if rbw else [])
    if hs == 4 and vs == 1:
        entries += [(529, 5, [(2126, 10000), (7152, 10000), (722, 10000)]), (274, 3, [8])]
    path = _write(tmp_path, "y.tif", tf.tiff_chunks_bytes(
        w, h, [coder(tf.ycbcr_units(y, cb, cr, hs, vs))], entries))
    assert assert_reads_as_jax(path).mode == "RGB"


def test_ycbcr_tiff_strips_read_as_jax(tmp_path):
    rng = np.random.default_rng(22)
    h, w, rows = 45, 61, 8
    y = rng.integers(0, 256, (h, w))
    cb, cr = (rng.integers(0, 256, (23, 31)) for _ in range(2))
    chunks = [tf.lzw_tiff(tf.ycbcr_units(y[r:r + rows], cb[r // 2:(r + rows) // 2],
                                         cr[r // 2:(r + rows) // 2], 2, 2))
              for r in range(0, h, rows)]
    assert_reads_as_jax(_write(tmp_path, "s.tif", tf.tiff_chunks_bytes(
        w, h, chunks, [(258, 3, [8, 8, 8]), (259, 3, [5]), (262, 3, [6]), (277, 3, [3]),
                       (530, 3, [2, 2])], rows_per_strip=rows)))


# ---- JPEG block smoothing ------------------------------------------------------------

def _first_scans(blob: bytes, n: int) -> bytes:
    starts = [i for i in range(len(blob) - 1) if blob[i] == 0xFF and blob[i + 1] == 0xDA]
    return blob[:starts[n]] + b"\xff\xd9"


SMOOTHED = [(16, 16, "L", 0, 1), (16, 9, "L", 0, 2), (33, 17, "RGB", 2, 1), (33, 17, "RGB", 2, 2),
            (21, 40, "RGB", 2, 1), (45, 61, "RGB", 1, 3), (45, 61, "RGB", 2, 5),
            (120, 160, "RGB", 2, 1), (40, 49, "RGB", 0, 4), (24, 40, "RGB", 2, 8)]


@pytest.mark.parametrize("h,w,mode,sub,scans", SMOOTHED,
                         ids=[f"{h}x{w}-{m}-{s}-{n}" for h, w, m, s, n in SMOOTHED])
def test_block_smoothed_progressive_jpeg_reads_as_jax(tmp_path, h, w, mode, sub, scans):
    img = Image.fromarray(smooth(h, w, 3, h + w)).convert(mode)
    blob = _pil_bytes(img, "JPEG", progressive=True, quality=80, subsampling=sub)
    assert_reads_as_jax(_write(tmp_path, "s.jpg", _first_scans(blob, scans)))


@pytest.mark.parametrize("factors", [((1, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1))],
                         ids=["440", "411"])
def test_block_smoothed_arithmetic_progressive_reads_as_jax(tmp_path, factors):
    blob = tf.jpeg_arith_bytes(smooth(21, 40, 3, 7), factors, 80, progressive=True)
    assert_reads_as_jax(_write(tmp_path, "a.jpg", _first_scans(blob, 1)))


def test_jpeg_dc_table_with_a_symbol_above_15_is_refused_as_libjpeg_does(tmp_path):
    """libjpeg's jpeg_make_d_derived_tbl refuses a DC table whose symbols
    (bit counts) exceed 15, even one the data never uses; so does the port."""
    blob = bytearray(_pil_bytes(Image.fromarray(smooth(16, 16, 1, 2)[:, :, 0]), "JPEG"))
    at = blob.find(b"\xff\xc4")
    assert blob[at + 4] >> 4 == 0                      # PIL writes the DC table first
    blob[at + 21 + sum(blob[at + 5:at + 21]) - 1] = 16
    path = _write(tmp_path, "dc.jpg", bytes(blob))
    with pytest.raises(OSError):
        Image.open(path).load()
    for read in (tds.load_gray, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match="DC symbol above 15") as err:
            read(path)
        assert path in str(err.value)


# ---- TGA -------------------------------------------------------------------------

def _tga(image_type, depth, w, h, flags, data, cmap=None, map_depth=0, start=0, id_section=b""):
    entries = 0 if cmap is None else len(cmap) // (2 if map_depth == 16 else map_depth // 8)
    return (bytes([len(id_section), 0 if cmap is None else 1, image_type])
            + struct.pack("<HHB", start, entries, map_depth)
            + struct.pack("<HHHHBB", 0, 0, w, h, depth, flags) + id_section + (cmap or b"")
            + data)


def _pil_image(mode: str, seed: int) -> Image.Image:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    if mode == "P":
        img = Image.fromarray(arr[:, :, 0], "P")
        img.putpalette(list(rng.integers(0, 256, 768)))
        return img
    if mode == "1":
        return Image.fromarray(arr[:, :, 0]).convert("1")
    return Image.fromarray(arr[:, :, 0] if mode == "L" else arr[:, :, :len(mode)], mode)


TGA_PIL = [(m, rle, o) for i, m in enumerate(("L", "LA", "P", "RGB", "RGBA", "1"))
           for rle, o in (((i % 2 == 0), -1), ((i % 2 == 1), 1))]


@pytest.mark.parametrize("mode,rle,orientation", TGA_PIL,
                         ids=[f"{m}-{'rle' if r else 'raw'}-{o}" for m, r, o in TGA_PIL])
def test_tga_written_by_pil_reads_as_jax(tmp_path, mode, rle, orientation):
    if mode == "1" and rle:
        rle = False        # PIL writes no RLE at 1 bit that it reads back
    blob = _pil_bytes(_pil_image(mode, len(mode)), "TGA", rle=rle, orientation=orientation)
    assert_reads_as_jax(_write(tmp_path, "x.tga", blob))


def _rle_literals(data: bytes, pixel: int) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        n = min(128, (len(data) - i) // pixel)
        out += bytes([n - 1]) + data[i:i + n * pixel]
        i += n * pixel
    return bytes(out)


def _tga_by_hand(name: str) -> bytes:
    rng = np.random.default_rng(len(name))
    px16 = rng.integers(0, 65536, (H, W)).astype("<u2").tobytes()
    idx = rng.integers(0, 40, (H, W)).astype(np.uint8).tobytes()
    gray = rng.integers(0, 256, H * W).astype(np.uint8).tobytes()
    return {
        "16-bit": lambda: _tga(2, 16, W, H, 0, px16),
        "16-bit-mirrored-top-down": lambda: _tga(2, 16, W, H, 0x30, px16),
        "24-bit-mirrored": lambda: _tga(2, 24, W, H, 0x10, rng.integers(
            0, 256, H * W * 3).astype(np.uint8).tobytes()),
        "map16-start-id": lambda: _tga(1, 8, W, H, 0x20, idx, rng.integers(
            0, 256, 60).astype(np.uint8).tobytes(), 16, start=10, id_section=b"hello"),
        "map24-start": lambda: _tga(1, 8, W, H, 0, idx, rng.integers(
            0, 256, 90).astype(np.uint8).tobytes(), 24, start=10),
        "rle-literals-cross-rows": lambda: _tga(11, 8, W, H, 0, _rle_literals(gray, 1)),
        "rle-32-bit": lambda: _tga(10, 32, W, H, 0x20, _rle_literals(rng.integers(
            0, 256, H * W * 4).astype(np.uint8).tobytes(), 4)),
    }[name]()


TGA_HAND = ["16-bit", "16-bit-mirrored-top-down", "24-bit-mirrored", "map16-start-id",
            "map24-start", "rle-literals-cross-rows", "rle-32-bit"]


@pytest.mark.parametrize("name", TGA_HAND)
def test_tga_by_hand_reads_as_jax(tmp_path, name):
    assert_reads_as_jax(_write(tmp_path, "x.tga", _tga_by_hand(name)))


TGA_REFUSED = {
    "map32": (lambda: _tga(1, 8, W, H, 0, bytes(H * W), bytes(120), 32), "32-bit colour maps"),
    "no-colour-map": (lambda: _tga(1, 8, W, H, 0, bytes(H * W)), "without a colour map"),
    "type3-24-bit": (lambda: _tga(3, 24, W, H, 0, bytes(3 * H * W)), "image type 3 at 24"),
    "truncated": (lambda: _tga(3, 8, W, H, 0, bytes(H * W - 5)), "truncated"),
    "run-across-rows": (lambda: _tga(11, 8, W, H, 0, bytes([0xFF, 5]) * 8), "crosses"),
    "rle-1-bit": (lambda: _tga(11, 1, W, H, 0, bytes([0xFF, 5]) * 8), "1 bit"),
}


@pytest.mark.parametrize("variant", sorted(TGA_REFUSED))
def test_tga_pil_cannot_load_raises_naming_the_file(tmp_path, variant):
    make, reason = TGA_REFUSED[variant]
    path = _write(tmp_path, f"{variant}.tga", make())
    with pytest.raises((OSError, ValueError)):
        Image.open(path).load()
    for read in (tds.load_gray, tds.load_depth, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match=reason) as err:
            read(path)
        assert path in str(err.value)


# ---- SGI and PCX ---------------------------------------------------------------------

SGI_PIL = [(m, b, shape) for m in ("L", "RGB", "RGBA") for b in (1, 2)
           for shape in ((H, W), (1, 40))][::2] + [("L", 2, (1, 40))]


@pytest.mark.parametrize("mode,bpc,shape", SGI_PIL,
                         ids=[f"{m}-{b}-{s[0]}x{s[1]}" for m, b, s in SGI_PIL])
def test_sgi_written_by_pil_reads_as_jax(tmp_path, mode, bpc, shape):
    img = _pil_image(mode, bpc).crop((0, 0, shape[1], shape[0]))
    assert_reads_as_jax(_write(tmp_path, "x.sgi", _pil_bytes(img, "SGI", bpc=bpc)))


def _sgi_rle(planes: np.ndarray, bpc: int) -> bytes:
    """An RLE SGI of planes [z, h, w] (top-down): rows bottom-up, runs of 5
    at every third position, literal runs elsewhere, each row ending 0."""
    z, h, w = planes.shape
    rows = []
    for c in range(z):
        for r in range(h):
            v, out, x = planes[c, h - 1 - r], bytearray(), 0
            while x < w:
                n = min(127, w - x)
                if x % 3 == 0 and n > 4:
                    out += (5).to_bytes(bpc, "big") + int(v[x]).to_bytes(bpc, "big")
                    x += 5
                else:
                    out += (0x80 | n).to_bytes(bpc, "big") + b"".join(
                        int(t).to_bytes(bpc, "big") for t in v[x:x + n])
                    x += n
            rows.append(bytes(out + bytes(bpc)))
    starts, at = [], 512 + 8 * len(rows)
    for row in rows:
        starts.append(at)
        at += len(row)
    head = struct.pack(">hBBHHHHll4s80sl404s", 474, 1, bpc, 3 if z > 1 else 2, w, h, z, 0, 255,
                       b"", b"rle", 0, b"")
    return (head + struct.pack(f">{len(rows)}I", *starts)
            + struct.pack(f">{len(rows)}I", *map(len, rows)) + b"".join(rows))


@pytest.mark.parametrize("z,bpc", [(1, 1), (3, 2), (4, 1)])
def test_sgi_run_length_encoded_reads_as_jax(tmp_path, z, bpc):
    planes = np.random.default_rng(z * bpc).integers(0, 1 << (8 * bpc), (z, 23, 41))
    assert_reads_as_jax(_write(tmp_path, "r.sgi", _sgi_rle(planes, bpc)))


@pytest.mark.parametrize("mode,shape", [("1", (21, 37)), ("L", (8, 16)), ("P", (21, 37)),
                                        ("RGB", (5, 301))],
                         ids=["1", "L", "P", "RGB-odd-width"])
def test_pcx_written_by_pil_reads_as_jax(tmp_path, mode, shape):
    img = _pil_image(mode, 7).resize((shape[1], shape[0]))
    assert_reads_as_jax(_write(tmp_path, "x.pcx", _pil_bytes(img, "PCX")))


def _pcx_planes(idx: np.ndarray, planes: int, stride_field=None) -> bytes:
    """A 1-bit PCX of ``planes`` bit planes (EGA colours), run-length coded
    bytes at or above 0xC0, each plane padded when the header's stride is
    not the computed one."""
    h, w = idx.shape
    stride = (w + 7) // 8
    head = (bytes([10, 5, 1, 1]) + struct.pack("<HHHHHH", 0, 0, w - 1, h - 1, 72, 72)
            + np.random.default_rng(w).integers(0, 256, 48).astype(np.uint8).tobytes()
            + bytes([0, planes]) + struct.pack("<HH", stride_field or stride, 1) + bytes(58))
    data = bytearray()
    for row in idx:
        for k in range(planes):
            line = np.packbits(((row >> k) & 1).astype(np.uint8)).tobytes()
            line += bytes(1) if stride_field not in (None, stride) and stride % 2 else b""
            for byte in line:
                data += bytes([0xC1, byte]) if byte >= 0xC0 else bytes([byte])
    return head + bytes(data)


@pytest.mark.parametrize("planes,width,stride", [(2, 37, None), (4, 40, None), (2, 37, 99),
                                                 (4, 37, 99)],
                         ids=["2-planes", "4-planes", "2-planes-padded", "4-planes-padded"])
def test_pcx_bit_planes_read_as_jax(tmp_path, planes, width, stride):
    idx = np.random.default_rng(planes + width).integers(0, 1 << planes, (13, width))
    assert_reads_as_jax(_write(tmp_path, "p.pcx", _pcx_planes(idx, planes, stride)))


# ---- DDS ---------------------------------------------------------------------------

def _dds(w, h, pfflags, fourcc=b"\0\0\0\0", bitcount=0, masks=(0, 0, 0, 0), data=b"",
         dx10=None):
    head = (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + bytes(44)
            + struct.pack("<4I", 32, pfflags, int.from_bytes(fourcc, "little"), bitcount)
            + struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return head + (struct.pack("<5I", dx10, 3, 0, 0, 1) if dx10 is not None else b"") + data


DDS_BLOCKS = [(b"DXT1", None, 8), (b"DXT3", None, 16), (b"DXT5", None, 16), (b"ATI1", None, 8),
              (b"BC5S", None, 16), (b"ATI2", None, 16), (b"DX10", 71, 8), (b"DX10", 74, 16),
              (b"DX10", 77, 16), (b"DX10", 80, 8), (b"DX10", 83, 16), (b"DX10", 84, 16)]


@pytest.mark.parametrize("fourcc,dxgi,size", DDS_BLOCKS,
                         ids=[f"{f.decode()}{'-' + str(d) if d else ''}" for f, d, _ in DDS_BLOCKS])
def test_dds_block_formats_read_as_jax(tmp_path, fourcc, dxgi, size):
    """Random blocks (both BC1 colour orders, every alpha table), at a size
    that is no multiple of 4."""
    w, h = 13, 9
    data = np.random.default_rng(size + (dxgi or 0)).integers(0, 256, 4 * 3 * size)
    assert_reads_as_jax(_write(tmp_path, "b.dds", _dds(w, h, 4, fourcc, data=data.astype(
        np.uint8).tobytes(), dx10=dxgi)))


DDS_MASKS = [(24, (0xFF0000, 0xFF00, 0xFF, 0), 0x40), (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                                         0x41),
             (16, (0xF800, 0x7E0, 0x1F, 0), 0x40), (16, (0xF00, 0xF0, 0xF, 0xF000), 0x41)]


@pytest.mark.parametrize("bits,masks,flags", DDS_MASKS,
                         ids=["rgb24", "rgba32", "rgb565", "rgba4444"])
def test_dds_bit_masks_read_as_jax(tmp_path, bits, masks, flags):
    data = np.random.default_rng(bits + flags).integers(0, 256, H * W * bits // 8)
    assert_reads_as_jax(_write(tmp_path, "m.dds", _dds(W, H, flags, bitcount=bits, masks=masks,
                                                        data=data.astype(np.uint8).tobytes())))


@pytest.mark.parametrize("kind", ["L", "LA", "P", "DX10-RGBA8"])
def test_dds_uncompressed_reads_as_jax(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    flags, bits, n, dxgi = {"L": (0x20000, 8, H * W, None), "LA": (0x20001, 16, 2 * H * W, None),
                            "P": (0x20, 8, 1024 + H * W, None),
                            "DX10-RGBA8": (4, 0, 4 * H * W, 28)}[kind]
    assert_reads_as_jax(_write(tmp_path, "u.dds", _dds(
        W, H, flags, b"DX10" if dxgi else b"\0\0\0\0", bits,
        data=rng.integers(0, 256, n).astype(np.uint8).tobytes(), dx10=dxgi)))


@pytest.mark.parametrize("pixel_format", ["DXT1", "DXT3", "DXT5", "BC5"])
def test_dds_written_by_pil_reads_as_jax(tmp_path, pixel_format):
    img = Image.fromarray(smooth(21, 37, 3, 4)).convert("RGB" if pixel_format == "BC5" else "RGBA")
    assert_reads_as_jax(_write(tmp_path, "p.dds", _pil_bytes(img, "DDS",
                                                            pixel_format=pixel_format)))


@pytest.mark.parametrize("dxgi", [97, 98, 99])
def test_dds_bc7_reads_as_jax(tmp_path, dxgi):
    """Random blocks of every BC7 mode and the reserved mode 8, 13 x 9."""
    rng = np.random.default_rng(dxgi)
    blocks = bytearray(rng.integers(0, 256, 12 * 16).astype(np.uint8).tobytes())
    for i in range(12):
        mode = (i + dxgi) % 9
        blocks[16 * i] = 0 if mode == 8 else (blocks[16 * i] & ~((2 << mode) - 1) & 0xFF) | (
            1 << mode)
    assert_reads_as_jax(_write(tmp_path, "b.dds", _dds(13, 9, 4, b"DX10", data=bytes(blocks),
                                                        dx10=dxgi)))


@pytest.mark.parametrize("dxgi,reason", [(94, "DXGI format 94"), (10, "DXGI format 10")],
                         ids=["BC6H-typeless", "RGBA16-float"])
def test_dds_formats_not_read_yet_raise_naming_the_file(tmp_path, dxgi, reason):
    """DXGI formats PIL refuses too (NotImplementedError); BC6H (95, 96) is
    read, in tests/test_torch_imageio_anim.py."""
    path = _write(tmp_path, "n.dds", _dds(8, 8, 4, b"DX10", data=bytes(64), dx10=dxgi))
    with pytest.raises(NotImplementedError):
        Image.open(path)
    for read in (tds.load_gray, tds.load_depth, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match=reason) as err:
            read(path)
        assert path in str(err.value)


# ---- PSD ---------------------------------------------------------------------------

def _psd(mode_id: int, bits: int, planes, compression: int, colour_data: bytes = b"") -> bytes:
    """A PSD with no resources or layers: the composite planes raw (0) or
    PackBits (1, a byte count per row and channel)."""
    h = planes[0].shape[0]
    w = planes[0].shape[1] * (8 if bits == 1 else 1)
    body = (b"8BPS" + struct.pack(">H6xHIIHH", 1, len(planes), h, w, bits, mode_id)
            + struct.pack(">I", len(colour_data)) + colour_data + bytes(8)
            + struct.pack(">H", compression))
    if compression == 0:
        return body + b"".join(p.astype(np.uint8).tobytes() for p in planes)
    rows = [tf.packbits(p[y].astype(np.uint8).tobytes()) for p in planes for y in range(h)]
    return body + b"".join(struct.pack(">H", len(r)) for r in rows) + b"".join(rows)


PSD = [("gray", 1, 1, 8), ("rgb", 3, 3, 8), ("rgba", 3, 4, 8), ("cmyk", 4, 4, 8),
       ("multichannel", 7, 2, 8), ("duotone", 8, 1, 8), ("lab", 9, 3, 8), ("palette", 2, 1, 8),
       ("bitmap", 0, 1, 1), ("rgb-16-bit", 3, 3, 16)]


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("name,mode_id,n,bits", PSD, ids=[c[0] for c in PSD])
def test_psd_composite_reads_as_jax(tmp_path, name, mode_id, n, bits, compression):
    rng = np.random.default_rng(mode_id * 2 + compression)
    cols = (W + 7) // 8 if bits == 1 else W
    planes = [np.repeat(rng.integers(0, 256, (H, cols // 4 + 1)), 4, 1)[:, :cols]
              for _ in range(n)]      # runs for PackBits
    table = rng.integers(0, 256, 768).astype(np.uint8).tobytes() if name == "palette" else b""
    path = _write(tmp_path, "x.psd", _psd(mode_id, bits, planes, compression, table))
    if bits == 16:                    # PIL has no mode for it
        with pytest.raises(Exception):
            Image.open(path)
        for read in (tds.load_gray, images_plain.decode):
            with pytest.raises(ValueError, match="16 bits") as err:
                read(path)
            assert path in str(err.value)
        return
    assert_reads_as_jax(path)


# ---- ICO and CUR --------------------------------------------------------------------

@pytest.mark.parametrize("mode,bitmap_format,sizes", [
    ("RGBA", "png", ((48, 48),)), ("L", "bmp", ((16, 16), (32, 32), (48, 48))),
    ("P", "bmp", ((48, 48),)), ("1", "bmp", ((32, 32), (48, 48))), ("RGB", "png", ((48, 48),))],
    ids=["rgba-png", "L-bmp-3", "P-bmp", "1-bmp-2", "rgb-png"])
def test_ico_written_by_pil_reads_as_jax(tmp_path, mode, bitmap_format, sizes):
    arr = smooth(48, 48, 4, 3)
    img = (Image.fromarray(arr[:, :, :3]).quantize(40) if mode == "P"
           else Image.fromarray(arr[:, :, :len(mode)] if len(mode) > 1 else arr[:, :, 0])
           .convert(mode))
    assert_reads_as_jax(_write(tmp_path, "x.ico", _pil_bytes(img, "ICO", sizes=list(sizes),
                                                            bitmap_format=bitmap_format)))


def _dib(img: Image.Image) -> bytes:
    """PIL's BMP of ``img`` as an icon's DIB: no file header, the height
    doubled, a random AND mask after the pixels."""
    dib = bytearray(_pil_bytes(img, "BMP")[14:])
    w, h = img.size
    dib[8:12] = (2 * h).to_bytes(4, "little")
    mask = np.random.default_rng(w * h).integers(0, 256, (w + 31) // 32 * 4 * h)
    return bytes(dib) + mask.astype(np.uint8).tobytes()


def _icon_file(entries, cursor: bool = False) -> bytes:
    """entries: (DIB, width, height, bits, colours) -> an ICO or CUR."""
    out = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    at, data = 6 + 16 * len(entries), b""
    for blob, w, h, bits, colours in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, 1, bits, len(blob),
                           at + len(data))
        data += blob
    return out + data


@pytest.mark.parametrize("mode,colours", [("1", 2), ("P", 16), ("L", 0), ("RGB", 0)])
@pytest.mark.parametrize("cursor", [False, True], ids=["ico", "cur"])
def test_icon_bitmaps_by_hand_read_as_jax(tmp_path, mode, colours, cursor):
    arr = smooth(20, 24, 3, 5)
    img = Image.fromarray(arr).quantize(16) if mode == "P" else Image.fromarray(arr).convert(mode)
    bits = {"1": 1, "P": 4, "L": 8, "RGB": 24}[mode]
    blob = _icon_file([(_dib(img), 24, 20, bits, colours)], cursor)
    assert_reads_as_jax(_write(tmp_path, "x.cur" if cursor else "x.ico", blob))


def test_icon_picks_as_pil(tmp_path):
    """ICO: the largest entry, of those the lowest colour depth; a 32-bit
    entry's alpha from its fourth bytes.  CUR: the last entry larger than
    the one before it in both dimensions."""
    arr = smooth(16, 16, 4, 6)
    low, high = _dib(Image.fromarray(arr[:, :, :3]).quantize(16)), _dib(Image.fromarray(
        arr[:, :, :3]))
    assert_reads_as_jax(_write(tmp_path, "pick.ico", _icon_file(
        [(high, 16, 16, 24, 0), (low, 16, 16, 4, 16)])))
    rows = arr[::-1][:, :, [2, 1, 0, 3]].tobytes()
    dib32 = struct.pack("<IiiHHIIiiII", 40, 16, 32, 1, 32, 0, len(rows), 0, 0, 0, 0) + rows
    assert_reads_as_jax(_write(tmp_path, "a.ico", _icon_file([(dib32 + bytes(64), 16, 16, 32,
                                                               0)])))
    big = _dib(Image.fromarray(smooth(24, 24, 3, 7)))
    assert_reads_as_jax(_write(tmp_path, "pick.cur", _icon_file(
        [(low, 16, 16, 4, 16), (big, 24, 24, 24, 0), (high, 16, 16, 24, 0)], cursor=True)))


# ---- QOI ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi_written_by_pil_reads_as_jax(tmp_path, mode):
    """Smooth areas (runs, DIFF and LUMA ops, index hits) beside noise (RGB
    and RGBA ops)."""
    arr = smooth(37, 53, 4, 8)
    arr[:, :20] //= 32
    arr[:5] = 7
    img = Image.fromarray(arr[:, :, :len(mode)], mode)
    assert_reads_as_jax(_write(tmp_path, "x.qoi", _pil_bytes(img, "QOI")))


# ---- IM, SUN, MSP, XBM, XPM ---------------------------------------------------------

def _im_image(mode: str, seed: int) -> Image.Image:
    rng = np.random.default_rng(seed)
    if mode == "I":
        return Image.fromarray(rng.integers(-2 ** 31, 2 ** 31, (H, W)).astype(np.int32))
    if mode in ("I;16", "I;16B"):
        return Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16)).convert(mode)
    if mode == "F":
        return Image.fromarray(rng.normal(100, 100, (H, W)).astype(np.float32))
    if mode in ("RGBX", "CMYK"):
        return _pil_image("RGB", seed).convert(mode)
    return _pil_image(mode, seed)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "I", "I;16", "I;16B", "F", "RGB", "RGBA",
                                  "RGBX", "CMYK"])
def test_im_written_by_pil_reads_as_jax(tmp_path, mode):
    assert_reads_as_jax(_write(tmp_path, "x.im", _pil_bytes(_im_image(mode, len(mode)), "IM")))


def test_im_header_variants_read_as_jax_or_are_refused(tmp_path):
    grey = (b"Image type: Greyscale image\r\nLut: 1\r\nImage size (x*y): 4*2\r\n" + bytes(20)
            + b"\x1a" + bytes(range(256)) * 3 + bytes(range(8)))
    assert_reads_as_jax(_write(tmp_path, "g.im", grey))
    assert_reads_as_jax(_write(tmp_path, "x.im", b"Image type: X 24 image\nImage size (x*y): "
                                                 b"4*2\n\x1a" + bytes(range(24))))
    ycc = _write(tmp_path, "y.im", b"Image type: YCC image\nImage size (x*y): 4*2\n\x1a"
                 + bytes(24))
    assert Image.open(ycc).mode == "YCbCr"     # PIL reads it; the port does not yet
    for read in (tds.load_gray, images_plain.decode):
        with pytest.raises(ValueError, match="YCC image") as err:
            read(ycc)
        assert ycc in str(err.value)


def _sun(w, h, depth, kind, data, cmap=b""):
    return (b"\x59\xa6\x6a\x95" + struct.pack(">7I", w, h, depth, len(data), kind,
                                              1 if cmap else 0, len(cmap)) + cmap + data)


def _sun_rle(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
            i = j
        else:
            out += b"\x80\x00" if data[i] == 0x80 else data[i:i + 1]
            i += 1
    return bytes(out)


SUN = [(d, k, c) for d in (1, 4, 8, 24, 32) for k in (1, 2, 3) for c in (False, True)
       if not (c and (d not in (4, 8) or k == 3))]


@pytest.mark.parametrize("depth,kind,cmap", SUN,
                         ids=[f"{d}-type{k}{'-cmap' if c else ''}" for d, k, c in SUN])
def test_sun_raster_reads_as_jax(tmp_path, depth, kind, cmap):
    rng = np.random.default_rng(depth * 10 + kind)
    stride = (W * depth + 15) // 16 * 2
    rows = np.repeat(rng.integers(0, 256, (H, stride // 4 + 1)), 4, 1)[:, :stride].astype(np.uint8)
    rows[0, :3] = 0x80
    data = _sun_rle(rows[:, :(W * depth + 7) // 8].tobytes()) if kind == 2 else rows.tobytes()
    table = rng.integers(0, 256, 3 * (16 if depth == 4 else 200)).astype(np.uint8).tobytes()
    assert_reads_as_jax(_write(tmp_path, "x.ras", _sun(W, H, depth, kind, data,
                                                       table if cmap else b"")))


@pytest.mark.parametrize("fmt", ["MSP", "XBM"])
def test_msp_and_xbm_written_by_pil_read_as_jax(tmp_path, fmt):
    assert_reads_as_jax(_write(tmp_path, "x." + fmt.lower(), _pil_bytes(_pil_image("1", 9),
                                                                         fmt)))


def test_msp_run_length_rows_read_as_jax(tmp_path):
    """A "LinS" file: runs of three or more equal bytes, literal runs of up
    to 3, the header's checksum made zero."""
    bits = np.repeat(np.random.default_rng(12).integers(0, 256, (12, 3)), 2, 1).astype(np.uint8)
    rows = []
    for r in bits:
        out, i = bytearray(), 0
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i]:
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i, r[i]])
                i = j
            else:
                k = min(3, len(r) - i)
                out += bytes([k]) + r[i:i + k].tobytes()
                i += k
        rows.append(bytes(out))
    head = bytearray(b"LinS" + struct.pack("<14H", 48, 12, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0))
    head[24:26] = int(np.bitwise_xor.reduce(np.frombuffer(bytes(head), "<u2"))).to_bytes(
        2, "little")
    blob = bytes(head) + struct.pack("<12H", *map(len, rows)) + b"".join(rows)
    assert_reads_as_jax(_write(tmp_path, "r.msp", blob))


XPM = {
    "one-char": b'/* XPM */\nstatic char *x[] = {\n"4 3 3 1",\n"a c #ff0000",\n"b c #00ff00",\n'
                b'"c c #0000ff",\n/* pixels */\n"abca",\n"bbcc",\n"ccba"\n};\n',
    "two-chars-none": b'/* XPM */\nstatic char *x[] = {\n"3 2 3 2",\n"aa c #102030",\n'
                      b'"bb c None",\n"cc s foo c #405060",\n"aaccaa",\n"ccaacc"};\n',
}


@pytest.mark.parametrize("name", sorted(XPM))
def test_xpm_reads_as_jax(tmp_path, name):
    assert_reads_as_jax(_write(tmp_path, "x.xpm", XPM[name]))


@pytest.mark.parametrize("mode,big_endian", [("F", False), ("L", True), ("I", False)])
def test_spider_written_by_pil_reads_as_jax(tmp_path, mode, big_endian):
    """PIL writes native (little-endian) floats; the big-endian file is the
    same samples byte-swapped, header included."""
    arr = np.random.default_rng(16).normal(100, 80, (H, W)).astype(np.float32)
    img = Image.fromarray(arr) if mode == "F" else Image.fromarray(
        np.clip(arr, 0, 255).astype(np.uint8)).convert(mode)
    blob = _pil_bytes(img, "SPIDER")
    if big_endian:
        blob = np.frombuffer(blob, "<f4").astype(">f4").tobytes()
    assert assert_reads_as_jax(_write(tmp_path, "x.spi", blob)).mode == "F"


# ---- WebP ---------------------------------------------------------------------------

def _webp_source(kind: str) -> np.ndarray:
    """Smooth (predictor, cross-colour), noise (literals), few colours
    (colour indexing with bundling), flat (one code)."""
    rng = np.random.default_rng(len(kind))
    arr = smooth(23, 37, 4, len(kind))
    if kind == "noise":
        arr = rng.integers(0, 256, (23, 37, 4)).astype(np.uint8)
    elif kind.startswith("colours"):
        table = rng.integers(0, 256, (int(kind[7:]), 4)).astype(np.uint8)
        arr = table[rng.integers(0, len(table), (23, 37))]
    elif kind == "flat":
        arr[:] = 77
    return arr


WEBP = [(m, k, method) for i, m in enumerate(("RGB", "RGBA", "L"))
        for j, k in enumerate(("smooth", "noise", "colours3", "colours12", "colours100", "flat"))
        for method in ((0, 6) if (i + j) % 2 else (4,))]


@pytest.mark.parametrize("mode,kind,method", WEBP, ids=[f"{m}-{k}-m{e}" for m, k, e in WEBP])
def test_lossless_webp_written_by_pil_reads_as_jax(tmp_path, mode, kind, method):
    arr = _webp_source(kind)
    img = Image.fromarray(arr[:, :, 0]) if mode == "L" else Image.fromarray(
        arr[:, :, :len(mode)], mode)
    assert_reads_as_jax(_write(tmp_path, "x.webp", _pil_bytes(
        img, "WEBP", lossless=True, method=method, quality=100 if method == 6 else 70)))


def test_lossless_webp_in_an_extended_file_reads_as_jax(tmp_path):
    """VP8X files (an EXIF chunk forces one): the flag decides RGB / RGBA;
    transparent pixels keep their colour with ``exact``."""
    arr = smooth(23, 37, 4, 3)
    exif = b"Exif\0\0MM\0*\0\0\0\x08\0\0"
    for mode in ("RGBA", "RGB"):
        img = Image.fromarray(arr[:, :, :len(mode)], mode)
        assert_reads_as_jax(_write(tmp_path, f"{mode}.webp", _pil_bytes(
            img, "WEBP", lossless=True, exif=exif)))
    arr[::3, ::2, 3] = 0
    assert_reads_as_jax(_write(tmp_path, "clear.webp", _pil_bytes(
        Image.fromarray(arr, "RGBA"), "WEBP", lossless=True, exact=True)))


LOSSY = [(s, q, m, a) for s, q, m, a in (((16, 16), 5, 0, False), ((23, 37), 50, 3, True),
                                          ((48, 64), 95, 6, False), ((3, 97), 75, 4, True),
                                          ((1, 1), 80, 4, False), ((40, 56), 20, 2, True))]


@pytest.mark.parametrize("shape,quality,method,alpha", LOSSY,
                         ids=[f"{s[0]}x{s[1]}-q{q}-m{m}{'-alpha' if a else ''}"
                              for s, q, m, a in LOSSY])
def test_lossy_webp_written_by_pil_reads_as_jax(tmp_path, shape, quality, method, alpha):
    """VP8 key frames (segments, both loop filters, 4x4 and 16x16 modes,
    fancy upsampling) and, with alpha, the ALPH chunk (VP8L-coded, row
    filters); noise for q50, smooth patterns else."""
    h, w = shape
    arr = (np.random.default_rng(quality).integers(0, 256, (h, w, 4)).astype(np.uint8)
           if quality == 50 else smooth(h, w, 4, quality + method))
    img = Image.fromarray(arr, "RGBA") if alpha else Image.fromarray(arr[:, :, :3])
    blob = _pil_bytes(img, "WEBP", quality=quality, method=method, alpha_quality=quality)
    assert_reads_as_jax(_write(tmp_path, "x.webp", blob))


# ---- identification and decompression bombs -------------------------------------------

def _fits_bytes() -> bytes:
    """A 4 x 3 8-bit FITS file, which PIL's FITS plugin opens and loads."""
    cards = ["SIMPLE  = T", "BITPIX  = 8", "NAXIS   = 2", "NAXIS1  = 4", "NAXIS2  = 3", "END"]
    return (b"".join(c.ljust(80).encode() for c in cards).ljust(2880)
            + bytes(range(12)).ljust(2880, b"\0"))


IDENTIFIED = {   # files of formats PIL reads and the port does not: refused naming them
    "FITS": _fits_bytes,
    "AVIF": lambda: _pil_bytes(_pil_image("RGB", 7), "AVIF"),
    "BUFR": lambda: b"BUFR" + bytes(60),      # PIL's stub: opens, cannot load
}


@pytest.mark.parametrize("fmt", sorted(IDENTIFIED))
def test_formats_pil_identifies_and_the_port_does_not_read_raise(tmp_path, fmt):
    path = _write(tmp_path, "x.img", IDENTIFIED[fmt]())
    for read in (tds.load_gray, tds.load_depth, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match=f"{fmt} files are not supported") as err:
            read(path)
        assert path in str(err.value)


def _j2k_bomb(kind: str) -> bytes:
    """A 200000 x 200000 gray codestream (its SIZ; PIL reads the size there),
    a 300 x 300 one in 1 x 1 tiles (OpenJPEG refuses more than 65535 tiles),
    or a JP2 whose ihdr says 200000 x 200000 around a small codestream."""
    small = _pil_bytes(_pil_image("L", 8), "JPEG2000", no_jp2=True)
    if kind == "j2k":
        return small[:8] + struct.pack(">II", 200000, 200000) + small[16:]
    if kind == "j2k-tiles":
        return small[:8] + struct.pack(">6I", 300, 300, 0, 0, 1, 1) + small[32:]
    return tf.jp2_bytes(small, 1, 7)[:48] + struct.pack(">II", 200000, 200000) + tf.jp2_bytes(
        small, 1, 7)[56:]


@pytest.mark.parametrize("kind", ["tga", "tiff", "bigtiff", "j2k", "j2k-tiles", "jp2"])
def test_decompression_bombs_are_refused(tmp_path, kind):
    if kind == "tga":
        blob = _tga(3, 8, 65535, 65535, 0, bytes(64))
    elif kind == "j2k-tiles":
        blob = _j2k_bomb(kind)
        with pytest.raises(OSError):
            Image.open(io.BytesIO(blob)).load()
    elif kind in ("j2k", "jp2"):
        blob = _j2k_bomb(kind)
        with pytest.raises(Image.DecompressionBombError):
            Image.open(io.BytesIO(blob))
    else:
        blob = tf.tiff_chunks_bytes(200000, 200000, [bytes(64)], [(258, 3, [8]), (259, 3, [1]),
                                                                 (262, 3, [1])],
                                    bigtiff=kind == "bigtiff")
    path = _write(tmp_path, "bomb", blob)
    for read in (tds.load_gray, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match="size") as err:
            read(path)
        assert path in str(err.value)


# ---- save_gray ---------------------------------------------------------------------

@pytest.mark.parametrize("ext", [".tga", ".icb", ".vda", ".vst", ".sgi", ".rgb", ".rgba", ".bw",
                                 ".pcx", ".dds", ".im"])
def test_save_gray_writes_pils_bytes(tmp_path, ext):
    """Files of the same name (SGI keeps the name's stem in its header) in two
    folders; noise, a flat image and bands (PCX's runs of at most 63)."""
    (tmp_path / "port").mkdir()
    (tmp_path / "pil").mkdir()
    for h, w in ((1, 1), (21, 37), (3, 300)):
        for arr in (np.random.default_rng(h * w).normal(128, 90, (h, w)),
                    np.full((h, w), 200.0), np.repeat((np.arange(w) // 70 * 60.0)[None], h, 0)):
            arr = arr.astype(np.float32)
            tds.save_gray(str(tmp_path / "port" / f"frame 1{ext}"), arr)
            jds.save_gray(str(tmp_path / "pil" / f"frame 1{ext}"), arr)
            assert ((tmp_path / "port" / f"frame 1{ext}").read_bytes()
                    == (tmp_path / "pil" / f"frame 1{ext}").read_bytes())


@pytest.mark.parametrize("ext", [".qoi", ".msp", ".xbm", ".blp", ".psd"])
def test_save_gray_refuses_what_pil_cannot_write_for_mode_l(tmp_path, ext):
    arr = np.zeros((4, 5), np.float32)
    with pytest.raises((KeyError, OSError, ValueError)):   # PIL has no PSD writer at all
        jds.save_gray(str(tmp_path / f"pil{ext}"), arr)
    with pytest.raises(ValueError, match=ext):
        tds.save_gray(str(tmp_path / f"port{ext}"), arr)


# ---- the fixtures of test_data/torch_io ----------------------------------------------

LATER = ["icl_bigtiff_fill2.tif", "icl_jpeg_ycbcr_420.tif", "icl_orientation_6.tif",
         "icl_progressive_3_scans.jpg", "icl_rgb_rle.tga", "icl_ycbcr_422_lzw.tif",
         "kitti_ccitt_g3_2d.tif", "kitti_ccitt_g4.tif", "icl_dxt1.dds", "icl_gray.sgi",
         "icl_rgb.pcx", "icl_rgb.ico", "icl_rgb.qoi", "icl_gray.im", "kitti_bilevel.xbm",
         "kitti_bilevel.msp", "icl_rgb_lossless.webp", "icl_rgba_lossy.webp"]


@pytest.mark.parametrize("name", LATER)
def test_later_fixtures_read_as_jax(name):
    assert_reads_as_jax(os.path.join(FIXTURES, name))


def test_kitti_tga_folder_reads_as_jax_and_as_the_png_frames():
    seq = os.path.join(FIXTURES, "kitti_tga")
    got_t, got_j = list(tds.iter_kitti_odometry(seq)), list(jds.iter_kitti_odometry(seq))
    assert len(got_t) == len(got_j) == 2
    kitti = os.path.join(REPO, "test_data", "kitti", "city")
    for i, (a, b) in enumerate(zip(got_t, got_j)):
        assert a.timestamp == b.timestamp
        for side in ("left", "right"):
            np.testing.assert_array_equal(getattr(a, side), getattr(b, side))
            png = jds.load_gray(os.path.join(kitti, f"image_{side}_{i}.png"))[:, 300:940]
            np.testing.assert_array_equal(getattr(a, side), png)


CHILD = r"""
import hashlib, json, sys
for name in ("jax", "jaxlib", "srrg2_proslam_tpu", "PIL"):
    sys.modules[name] = None
import numpy as np
from srrg2_proslam_tpu_torch.io import datasets, images, images_plain
manifest = json.load(open("test_data/torch_io/MANIFEST.json"))
sha = lambda a: hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()).hexdigest()
for name in ("kitti_tga/image_1/000001.tga", "kitti_ccitt_g4.tif", "icl_jpeg_ycbcr_420.tif",
             "icl_ycbcr_422_lzw.tif", "icl_progressive_3_scans.jpg", "icl_orientation_6.tif",
             "icl_dxt1.dds", "icl_rgb.ico", "icl_gray.im", "kitti_bilevel.xbm",
             "icl_rgb_lossless.webp", "icl_rgba_lossy.webp"):
    path = "test_data/torch_io/" + name
    plain = images_plain.decode(path)
    assert sha(datasets.load_gray(path)) == manifest[name]["load_gray_sha256"], name
    assert sha(images.gray_f32(plain)) == manifest[name]["load_gray_sha256"], name
    assert sha(datasets.load_depth(path)) == manifest[name]["load_depth_sha256"], name
print("decoded without jax and PIL")
"""


def test_port_reads_the_later_formats_without_jax_or_pil():
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "decoded without jax and PIL"
