"""GIF, PNM / PFM and BMP through the port's readers, to the bit as the JAX
package reads them through PIL, on the CPU; ``save_gray``'s TIFF and GIF
files against the manifest.

GIF files come from PIL's writer (mode L: interlaced, the used gray levels
as the colour table) and from ``tests/torch_imagefiles.py::gif_bytes``
(local colour tables, an identity gray table, which PIL opens as L, a
transparent index, a frame off the canvas's corner or past its edge, a
second frame, code sizes below 8).  PNM files are written here: plain
P1 / P2 / P3 with comments, P4, P5 / P6 at maxvals that PIL rescales, Pf
either byte order.  BMP files come from
``tests/torch_imagefiles.py::bmp_bytes`` (PIL writes only uncompressed
8/24/32-bit ones): 1/4/8-bit palettes, the black / white two-entry
palette at 1 and 8 bits, OS/2 headers, 16-bit 5-5-5 and 5-6-5, PIL's
24- and 32-bit bit-field layouts under 40- and 108-byte headers, RLE8 and
RLE4 with encoded and absolute runs, deltas and odd counts.  Bounds,
every case: the port's ``load_gray`` and ``load_depth`` equal the JAX
package's to the bit, the library equals its plain twin in samples, mode
and palette, and the mode is PIL's; refused variants raise a
``ValueError`` naming the file and the feature.
"""
import hashlib
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from srrg2_proslam_tpu.io import datasets as jds  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets as tds  # noqa: E402
from srrg2_proslam_tpu_torch.io import images, images_plain  # noqa: E402
from test_torch_imageio_tiff import assert_reads_as_jax  # noqa: E402
from torch_imagefiles import bmp_bytes, gif_bytes  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
with open(os.path.join(REPO, "test_data", "torch_io", "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)
RNG = np.random.default_rng(0)
PALETTE = RNG.integers(0, 256, (256, 3))
RAMP = np.repeat(np.arange(256)[:, None], 3, 1)
IDX = RNG.integers(0, 256, (23, 37))
SMALL = RNG.integers(0, 4, (23, 37))

GIFS = {
    "global": lambda: gif_bytes([dict(indices=IDX)], (37, 23), PALETTE),
    "global-interlaced": lambda: gif_bytes([dict(indices=IDX, interlace=True)], (37, 23),
                                           PALETTE),
    "identity-table-opens-as-L": lambda: gif_bytes([dict(indices=IDX)], (37, 23), RAMP),
    "no-table-opens-as-L": lambda: gif_bytes([dict(indices=IDX)], (37, 23)),
    "local-table-2bit": lambda: gif_bytes([dict(indices=SMALL, palette=PALETTE[:4], bits=2)],
                                          (37, 23), PALETTE),
    "local-identity-table": lambda: gif_bytes([dict(indices=SMALL, palette=RAMP[:4], bits=2)],
                                              (37, 23), PALETTE),
    "offset-transparent": lambda: gif_bytes([dict(indices=SMALL, offset=(5, 3), transparency=2,
                                                  palette=PALETTE[:4], bits=2)], (50, 30),
                                            PALETTE),
    "frame-past-the-screen": lambda: gif_bytes([dict(indices=IDX, offset=(10, 9))], (20, 20),
                                               PALETTE),
    "two-frames": lambda: gif_bytes([dict(indices=IDX), dict(indices=IDX[::-1])], (37, 23),
                                    PALETTE),
    "table-full-lzw": lambda: gif_bytes([dict(indices=RNG.integers(0, 256, (120, 150)),
                                              interlace=True)], (150, 120), PALETTE),
    "gif87a": lambda: gif_bytes([dict(indices=IDX)], (37, 23), PALETTE[:256], b"GIF87a"),
}


@pytest.mark.parametrize("name", sorted(GIFS))
def test_gif_reads_as_jax(tmp_path, name):
    path = str(tmp_path / "x.gif")
    with open(path, "wb") as f:
        f.write(GIFS[name]())
    assert_reads_as_jax(path)


@pytest.mark.parametrize("size,levels", [((15, 40), 256), ((37, 53), 256), ((64, 64), 3),
                                         ((16, 16), 1), ((120, 160), 256)])
def test_gif_written_by_pil_reads_as_jax(tmp_path, size, levels):
    rng = np.random.default_rng(size[0])
    arr = (rng.integers(0, levels, size) * (255 // max(levels - 1, 1))).astype(np.uint8)
    path = str(tmp_path / "x.gif")
    Image.fromarray(arr).save(path)
    assert_reads_as_jax(path)


def _plain(magic: str, values: np.ndarray, w: int, h: int, maxval=None) -> bytes:
    head = f"{magic}\n# a comment\n{w} {h}\n" + ("" if maxval is None else f"{maxval}\n")
    body = " ".join(str(int(v)) for v in values.reshape(-1))
    lines = [body[i:i + 68] for i in range(0, len(body), 68)]     # lines split mid-token
    return head.encode() + "\n".join(lines).encode() + b"\n"


def _pnm(kind: str, maxval: int) -> bytes:
    rng = np.random.default_rng(maxval)
    a = rng.integers(0, maxval + 1, (9, 13, 3))
    wide = ">u2" if maxval > 255 else np.uint8
    if kind == "P2":
        return _plain("P2", a[:, :, 0], 13, 9, maxval)
    if kind == "P3":
        return _plain("P3", a, 13, 9, maxval)
    if kind == "P5":
        return f"P5\n13 9\n{maxval}\n".encode() + a[:, :, 0].astype(wide).tobytes()
    return f"P6 13 9 {maxval}\n".encode() + a.astype(wide).tobytes()


PNM_CASES = [(k, m) for k in ("P2", "P3", "P5", "P6") for m in (1, 15, 255, 1000, 65535)]


@pytest.mark.parametrize("kind,maxval", PNM_CASES, ids=[f"{k}-{m}" for k, m in PNM_CASES])
def test_pnm_reads_as_jax(tmp_path, kind, maxval):
    """P5 / P6 take the native decoder in both packages; the library and its
    twin read them as PIL does (rescaled), held to PIL's mode here."""
    path = str(tmp_path / ("x.ppm" if kind in ("P3", "P6") else "x.pgm"))
    with open(path, "wb") as f:
        f.write(_pnm(kind, maxval))
    assert_reads_as_jax(path)
    if kind in ("P2", "P3"):
        want = np.asarray(Image.open(path))
        got = images.decode(path).samples
        np.testing.assert_array_equal(got.reshape(want.shape), want)


BITS = np.random.default_rng(7).integers(0, 2, (9, 13))
FLOAT = np.random.default_rng(8).normal(0, 300, (9, 13)).astype(np.float32)
BITMAPS = {
    "P1": lambda: _plain("P1", BITS, 13, 9),
    "P1-no-spaces": lambda: b"P1 13 9 " + "".join(map(str, BITS.reshape(-1))).encode(),
    "P4": lambda: b"P4\n13 9\n" + np.packbits(BITS, axis=1).tobytes(),
    "Pf-little-endian": lambda: b"Pf\n13 9\n-1.0\n" + FLOAT[::-1].astype("<f4").tobytes(),
    "Pf-big-endian": lambda: b"Pf\n13 9\n2.5\n" + FLOAT[::-1].astype(">f4").tobytes(),
}


@pytest.mark.parametrize("name", sorted(BITMAPS))
def test_pbm_and_pfm_read_as_jax(tmp_path, name):
    path = str(tmp_path / ("x.pfm" if name.startswith("Pf") else "x.pbm"))
    with open(path, "wb") as f:
        f.write(BITMAPS[name]())
    assert_reads_as_jax(path)


def test_colour_pfm_is_refused_as_pil_refuses_it(tmp_path):
    """PIL opens Pf only: a colour PF raises in both packages."""
    path = str(tmp_path / "x.pfm")
    with open(path, "wb") as f:
        f.write(b"PF\n13 9\n-1.0\n" + np.repeat(FLOAT[:, :, None], 3, 2).tobytes())
    for read in (jds.load_gray, tds.load_gray, images_plain.decode):
        with pytest.raises(Exception) as err:
            read(path)
        assert read is jds.load_gray or ("PF" in str(err.value) and path in str(err.value))


@pytest.mark.parametrize("extension", [".tif", ".gif"])
def test_save_gray_tiff_and_gif_match_the_manifest(tmp_path, extension):
    want = MANIFEST["save_gray" + extension.replace(".", "_")]
    path = str(tmp_path / f"k{extension}")
    tds.save_gray(path, tds.load_gray(os.path.join(REPO, want["source"])))
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == want["pil_file_sha256"]
    gray = tds.load_gray(path)
    assert hashlib.sha256(gray.tobytes()).hexdigest() == want["load_gray_sha256"]
    np.testing.assert_array_equal(images.gray_f32(images_plain.decode(path)), gray)


_B = np.random.default_rng(3)
_BH, _BW = 13, 19
_RAMP8 = np.repeat(np.arange(256)[:, None], 3, 1)
_RUNS = np.repeat(_B.integers(0, 200, (_BH, 7)), 3, axis=1)[:, :_BW]
BMPS = {
    "1bit": lambda: bmp_bytes(_B.integers(0, 2, (_BH, _BW)), 1,
                              palette=_B.integers(0, 256, (2, 3))),
    "1bit-black-white": lambda: bmp_bytes(_B.integers(0, 2, (_BH, _BW)), 1,
                                          palette=[[0, 0, 0], [255, 255, 255]]),
    "4bit": lambda: bmp_bytes(_B.integers(0, 16, (_BH, _BW)), 4,
                              palette=_B.integers(0, 256, (16, 3))),
    "8bit-black-white": lambda: bmp_bytes(_B.integers(0, 2, (_BH, _BW)), 8,
                                          palette=[[0, 0, 0], [255, 255, 255]]),
    "8bit-20-colours": lambda: bmp_bytes(_B.integers(0, 20, (_BH, _BW)), 8,
                                         palette=_B.integers(0, 256, (20, 3))),
    "os2-8bit": lambda: bmp_bytes(_B.integers(0, 256, (_BH, _BW)), 8, header=12,
                                  palette=_B.integers(0, 256, (256, 3))),
    "os2-4bit": lambda: bmp_bytes(_B.integers(0, 16, (_BH, _BW)), 4, header=12,
                                  palette=_B.integers(0, 256, (16, 3))),
    "os2-24bit": lambda: bmp_bytes(_B.integers(0, 256, (_BH, _BW, 3)), 24, header=12),
    "16bit-555": lambda: bmp_bytes(_B.integers(0, 256, (_BH, _BW, 3)), 16),
    "16bit-565-bitfields": lambda: bmp_bytes(_B.integers(0, 256, (_BH, _BW, 3)), 16,
                                             compression=3, masks=(0xF800, 0x7E0, 0x1F)),
    "16bit-555-bitfields-56": lambda: bmp_bytes(_B.integers(0, 256, (_BH, _BW, 3)), 16,
                                                header=56, compression=3,
                                                masks=(0x7C00, 0x3E0, 0x1F, 0)),
    "24bit-bitfields": lambda: bmp_bytes(_B.integers(0, 256, (_BH, _BW, 3)), 24,
                                         compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
    "rle8": lambda: bmp_bytes(_RUNS * (_B.random((_BH, _BW)) < 0.8), 8, compression=1,
                              palette=_B.integers(0, 256, (256, 3))),
    "rle8-gray-ramp": lambda: bmp_bytes(_RUNS, 8, compression=1, palette=_RAMP8),
    "rle4": lambda: bmp_bytes((_RUNS % 16) * (_B.random((_BH, _BW)) < 0.8), 4,
                              compression=2, palette=_B.integers(0, 256, (16, 3))),
    "rle4-odd-absolute-runs": lambda: bmp_bytes(_B.integers(0, 16, (_BH, 17)), 4,
                                                compression=2,
                                                palette=_B.integers(0, 256, (16, 3))),
}
for _hdr in (40, 108):
    for _m in [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
               (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
               (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
               (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]:
        if _hdr == 40 and _m == (0xFF, 0xFF00, 0xFF0000, 0xFF000000):
            continue                       # its alpha-free RGB layout: PIL refuses it
        BMPS[f"32bit-bitfields-{_hdr}-{'-'.join('%x' % v for v in _m)}"] = (
            lambda hdr=_hdr, m=_m: bmp_bytes(_B.integers(0, 256, (_BH, _BW, 4)), 32,
                                             header=hdr, compression=3, masks=m))


@pytest.mark.parametrize("name", sorted(BMPS))
def test_bmp_reads_as_jax(tmp_path, name):
    path = str(tmp_path / "x.bmp")
    with open(path, "wb") as f:
        f.write(BMPS[name]())
    assert_reads_as_jax(path)


BMP_REFUSED = {
    "4bit-gray-ramp": (lambda: bmp_bytes(_B.integers(0, 16, (_BH, _BW)), 4,
                                         palette=np.repeat(np.arange(16)[:, None], 3, 1)),
                       "gray ramp"),
    "16bit-other-bitfields": (lambda: bmp_bytes(_B.integers(0, 256, (_BH, _BW, 3)), 16,
                                                compression=3, masks=(0xF000, 0xF00, 0xF0)),
                              "bit-field layout"),
    "jpeg-compression": (lambda: bmp_bytes(_B.integers(0, 256, (_BH, _BW, 3)), 24)[:30]
                         + struct.pack("<I", 4)
                         + bmp_bytes(_B.integers(0, 256, (_BH, _BW, 3)), 24)[34:],
                         "compression 4"),
}


@pytest.mark.parametrize("variant", sorted(BMP_REFUSED))
def test_refused_bmp_raises_naming_the_file(tmp_path, variant):
    make, reason = BMP_REFUSED[variant]
    path = str(tmp_path / f"{variant}.bmp")
    with open(path, "wb") as f:
        f.write(make())
    for read in (tds.load_gray, tds.load_depth, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match=reason) as err:
            read(path)
        assert path in str(err.value)
