"""JPEG 2000 through the port's readers, to the bit as the JAX package reads
it through PIL (OpenJPEG 2.5), on the CPU.

Files are written at test time from seeded arrays by PIL (codestreams and
JP2 files: L, I;16, LA, RGB and RGBA; the 5/3 and 9/7 wavelets with and
without the colour transform; quality layers by rate and by dB; 1-6
resolutions; code-block and precinct sizes; tiles with an offset and an
image offset; the five progression orders; signed samples; comments and
PLT markers), then rewritten by ``tests/torch_imagefiles.py`` where PIL
writes no such file: SOP markers ahead of the packets, EPH markers after
their headers, the headers packed into PPT or PPM segments, POC markers, an
ROI max-shift (RGN), a scalar-derived quantisation, other precisions and signedness in the SIZ
(and the JP2 ihdr), subsampled components (single-component codestreams
merged per tile, tiles and images starting on odd rows), JP2 files of other
box layouts, palettes, CMYK, sYCC and colour spaces PIL guesses.
Bounds, every case: the port's ``load_gray`` and ``load_depth`` equal the
JAX package's to the bit, the library's samples and mode equal its plain
twin's (on files of at most 64 x 64, the twin's tier-1 being Python; the
library alone takes the larger ones) and the mode is PIL's.  The features PIL's
writer cannot produce and the port refuses raise a ``ValueError`` naming
the file and the feature.  The ``tum_jp2`` folder of ``test_data/torch_io``
reads frame for frame as the JAX package reads it, and RGB-D over it runs
alike in both packages (the bounds of ``test_torch_imageio_tiff.py``).
"""
import io
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)

from srrg2_proslam_tpu.io import datasets as jds  # noqa: E402
from srrg2_proslam_tpu.models import frontend as jfe  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets as tds  # noqa: E402
from srrg2_proslam_tpu_torch.io import images, images_plain  # noqa: E402
from srrg2_proslam_tpu_torch.models import frontend  # noqa: E402
from test_torch_imageio_tiff import _assert_runs_equal, _jax_run, _port_run  # noqa: E402
from torch_imagefiles import (j2k_join, j2k_merged, j2k_packet_spans, j2k_segments,  # noqa: E402
                              j2k_with_eph, j2k_with_packed_headers, j2k_with_sop, jp2_bytes)

REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
FIXTURES = os.path.join(REPO, "test_data", "torch_io")
H, W = 40, 52
TWIN_MAX = 64 * 64


def smooth(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Waves plus noise: many bit-planes and code-blocks in every band."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = [128 + 100 * np.sin(x / 5 + k + seed) * np.cos(y / 7 - k) + rng.normal(0, 8, (h, w))
              for k in range(c)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def image(mode: str, seed: int, h: int = H, w: int = W) -> Image.Image:
    a = smooth(h, w, 4, seed)
    if mode == "I;16":
        return Image.fromarray((a[:, :, 0].astype(np.uint16) * 251 + a[:, :, 1]))
    if mode == "L":
        return Image.fromarray(a[:, :, 0])
    return Image.fromarray(a[:, :, :{"LA": 2, "RGB": 3, "RGBA": 4}[mode]], mode)


def pil_bytes(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def write(tmp_path, name: str, blob: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def assert_reads_as_jax(path: str):
    """Library == twin (small files), mode == PIL's, load_gray / load_depth
    == the JAX package's."""
    pil = Image.open(path)
    lib = images.decode(path)
    assert lib.mode == pil.mode
    if lib.samples.shape[0] * lib.samples.shape[1] <= TWIN_MAX:
        plain = images_plain.decode(path)
        assert plain.mode == lib.mode and plain.samples.dtype == lib.samples.dtype
        np.testing.assert_array_equal(lib.samples, plain.samples)
    for name in ("load_gray", "load_depth"):
        got, want = getattr(tds, name)(path), getattr(jds, name)(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# (mode, writer keywords); every case written once as a codestream, once as JP2
PIL_CASES = [
    ("L", {}), ("L", dict(irreversible=True)),
    ("I;16", {}), ("I;16", dict(irreversible=True, quality_mode="dB", quality_layers=[60, 80])),
    ("LA", {}), ("LA", dict(irreversible=True)),
    ("RGB", dict(mct=1)), ("RGB", dict(irreversible=True, mct=1)), ("RGB", dict(mct=0)),
    ("RGB", dict(irreversible=True, mct=0)),
    ("RGBA", dict(mct=1)), ("RGBA", dict(irreversible=True, mct=1)),
    ("L", dict(quality_mode="rates", quality_layers=[40, 20, 10, 5])),
    ("RGB", dict(irreversible=True, mct=1, quality_mode="rates", quality_layers=[30, 10, 3])),
    ("L", dict(irreversible=True, quality_mode="dB", quality_layers=[25, 35, 45])),
    *[("L", dict(num_resolutions=n)) for n in range(1, 7)],
    ("L", dict(codeblock_size=(4, 4))), ("I;16", dict(codeblock_size=(64, 16))),
    ("RGB", dict(codeblock_size=(16, 8), irreversible=True, mct=1)),
    ("L", dict(precinct_size=(16, 16), num_resolutions=3)),
    ("RGB", dict(precinct_size=(32, 16), num_resolutions=4, mct=1)),
    ("L", dict(tile_size=(24, 20), tile_offset=(5, 3), offset=(9, 4))),
    ("RGB", dict(tile_size=(33, 27), tile_offset=(2, 1), offset=(3, 5), irreversible=True,
                 mct=1, num_resolutions=3)),
    *[(mode, dict(progression=prog, precinct_size=(16, 16), codeblock_size=(8, 8),
                  quality_layers=[30, 10, 2], tile_size=(32, 24), mct=1))
      for mode, prog in (("RGB", "LRCP"), ("RGB", "RLCP"), ("RGBA", "RPCL"), ("RGB", "PCRL"),
                         ("LA", "CPRL"))],
    ("L", dict(signed=True)), ("RGB", dict(signed=True, irreversible=True, mct=1)),
    ("L", dict(comment="a comment", plt=True)), ("I;16", dict(plt=True, tile_size=(32, 32))),
]


@pytest.mark.parametrize("kind", ["j2k", "jp2"])
@pytest.mark.parametrize("mode,kw", PIL_CASES,
                         ids=[f"{m}-" + "-".join(f"{k}={v}" for k, v in kw.items())
                              for m, kw in PIL_CASES])
def test_jpeg2000_written_by_pil_reads_as_jax(tmp_path, kind, mode, kw):
    blob = pil_bytes(image(mode, len(str(kw))), no_jp2=kind == "j2k", **kw)
    assert blob[:4] == (b"\xff\x4f\xff\x51" if kind == "j2k" else b"\0\0\0\x0c")
    assert_reads_as_jax(write(tmp_path, f"x.{kind}", blob))


LARGE = [("RGB", (240, 320), dict(irreversible=True, mct=1, quality_mode="rates",
                                  quality_layers=[40, 20, 10])),
         ("I;16", (200, 330), dict(tile_size=(128, 128), progression="RPCL",
                                   precinct_size=(64, 64))),
         ("L", (257, 190), dict(irreversible=True, num_resolutions=6, progression="CPRL",
                                tile_size=(100, 90), tile_offset=(7, 11), offset=(9, 13)))]


@pytest.mark.parametrize("mode,shape,kw", LARGE, ids=[f"{m}-{s[0]}x{s[1]}" for m, s, _ in LARGE])
def test_larger_jpeg2000_reads_as_jax_through_the_library(tmp_path, mode, shape, kw):
    blob = pil_bytes(image(mode, shape[0], *shape), **kw)
    assert_reads_as_jax(write(tmp_path, "x.jp2", blob))


# ---- rewrites of PIL's files: what PIL writes no file for but reads ----------------------

def _replace(segs, marker, fn):
    return [(m, fn(body) if m == marker else body) for m, body in segs]


def _siz_precision(cs: bytes, prec: int, signed: bool) -> bytes:
    main, parts = j2k_segments(cs)

    def siz(body):
        n = struct.unpack(">H", body[34:36])[0]
        comps = b"".join(bytes([(prec - 1) | (0x80 if signed else 0)]) + body[37 + 3 * c:39 + 3 * c]
                         for c in range(n))
        return body[:36] + comps
    return j2k_join(_replace(main, 0xFF51, siz), parts)


def _derived(cs: bytes) -> bytes:
    """QCD of an irreversible codestream -> scalar derived (the LL step only)."""
    main, parts = j2k_segments(cs)
    return j2k_join(_replace(main, 0xFF5C, lambda b: bytes([(b[0] & 0xE0) | 1]) + b[1:3]), parts)


def _with_segment(cs: bytes, marker: int, body: bytes, tile: bool = False) -> bytes:
    main, parts = j2k_segments(cs)
    if tile:
        parts[0][1].append((marker, body))
    else:
        main.append((marker, body))
    return j2k_join(main, parts)


def _cod(cs: bytes, fn) -> bytes:
    main, parts = j2k_segments(cs)
    return j2k_join(_replace(main, 0xFF52, fn), parts)


def _pclr(ne: int, npc: int, depth_byte: int = 7, seed: int = 0) -> bytes:
    """A pclr box body of ``ne`` random entries of ``npc`` components of
    ``depth_byte`` + 1 bits (two bytes each above 8), entries 5 and 9
    repeating entry 2."""
    pal = np.random.default_rng(seed).integers(0, 1 << (depth_byte + 1), (ne, npc))
    pal[[k for k in (5, 9) if k < ne]] = pal[2 % ne]
    return (struct.pack(">HB", ne, npc) + bytes([depth_byte] * npc)
            + pal.astype(">u2" if depth_byte >= 8 else np.uint8).tobytes())


_CMAP = struct.pack(">HBBHBBHBB", 0, 1, 0, 0, 1, 1, 0, 1, 2)


def _located(cs: bytes):
    return cs, j2k_packet_spans(cs)


def _many_packets(**kw) -> bytes:
    """Four tiles, three layers, LRCP over 16 x 16 precincts, PLT markers:
    432 packets."""
    return pil_bytes(image("RGB", 25), no_jp2=True, mct=1, tile_size=(32, 24),
                     quality_layers=[20, 8, 2], precinct_size=(16, 16), num_resolutions=3,
                     plt=True, **kw)


def _subsampled(factors, shape=(33, 41), seed=0, offset=(0, 0), tile=None, **kw) -> bytes:
    """A codestream of noise components, component c subsampled by
    ``factors[c]``, the image at ``offset`` on the reference grid, in tiles
    of ``tile`` = (width, height) from the grid's origin (one PIL codestream
    per tile-component, merged)."""
    rng = np.random.default_rng(seed)
    (h, w), (ox, oy) = shape, offset
    tw, th = tile or (w + ox, h + oy)
    pieces = []
    for ty in range(0, h + oy, th):
        for tx in range(0, w + ox, tw):
            x0, y0, x1, y1 = max(tx, ox), max(ty, oy), min(tx + tw, w + ox), min(ty + th, h + oy)
            pieces.append([])
            for dx, dy in factors:
                cx0, cy0, cx1, cy1 = -(-x0 // dx), -(-y0 // dy), -(-x1 // dx), -(-y1 // dy)
                noise = rng.integers(0, 256, (cy1 - cy0, cx1 - cx0), np.uint8)
                pieces[-1].append(pil_bytes(Image.fromarray(noise), no_jp2=True, plt=True,
                                            num_resolutions=3, offset=(cx0, cy0),
                                            tile_size=(cx1, cy1), tile_offset=(0, 0), **kw))
    return j2k_merged(pieces, factors, (w + ox, h + oy, ox, oy, tw, th, 0, 0))


def _poc(*entries) -> bytes:
    return b"".join(struct.pack(">BBHBBB", *e) for e in entries)


REWRITES = {
    # precision and signedness in the SIZ: PIL's shift and offset, OpenJPEG's DC shift
    "L-as-6-bit": lambda: _siz_precision(pil_bytes(image("L", 1), no_jp2=True), 6, False),
    "L-as-5-bit-signed": lambda: _siz_precision(pil_bytes(image("L", 2), no_jp2=True), 5, True),
    "L-as-12-bit": lambda: _siz_precision(pil_bytes(image("L", 3), no_jp2=True), 12, False),
    "L-as-9-bit-signed": lambda: _siz_precision(pil_bytes(image("L", 4), no_jp2=True), 9, True),
    "RGB-as-10-bit": lambda: _siz_precision(pil_bytes(image("RGB", 5), no_jp2=True, mct=1),
                                            10, False),
    "I16-as-14-bit-signed": lambda: _siz_precision(
        pil_bytes(image("I;16", 6), no_jp2=True, irreversible=True), 14, True),
    # above 16 bits PIL reads four bytes a sample
    "L-as-20-bit": lambda: _siz_precision(pil_bytes(image("L", 28), no_jp2=True), 20, False),
    "I16-as-24-bit-signed": lambda: _siz_precision(
        pil_bytes(image("I;16", 29), no_jp2=True, irreversible=True), 24, True),
    "RGB-as-17-bit": lambda: _siz_precision(pil_bytes(image("RGB", 30), no_jp2=True, mct=1),
                                            17, False),
    "L-as-31-bit": lambda: _siz_precision(pil_bytes(image("L", 31), no_jp2=True), 31, False),
    # the JP2 ihdr's bit depth: PIL reads 9 bits as L there (I;16 in a codestream)
    "jp2-L-as-9-bit": lambda: jp2_bytes(
        _siz_precision(pil_bytes(image("L", 7), no_jp2=True), 9, False), 1, 8),
    "jp2-L-as-10-bit": lambda: jp2_bytes(
        _siz_precision(pil_bytes(image("L", 8), no_jp2=True), 10, False), 1, 9),
    "derived-quantisation": lambda: _derived(
        pil_bytes(image("RGB", 9), no_jp2=True, irreversible=True, mct=1)),
    "sop": lambda: j2k_with_sop(pil_bytes(image("RGB", 10), no_jp2=True, plt=True, mct=1,
                                          tile_size=(32, 32), quality_layers=[20, 5],
                                          precinct_size=(16, 16), num_resolutions=3)),
    # ROI max-shift: every coefficient shifted up and back down (main and
    # tile RGN, the reversible and the irreversible path)
    "rgn": lambda: _with_segment(_with_segment(_CS(26), 0xFF5E, b"\x00\x00\x05"),
                                 0xFF5E, b"\x02\x00\x07", tile=True),
    "rgn-irreversible": lambda: _with_segment(_CS(27, irreversible=True), 0xFF5E,
                                              b"\x01\x00\x0b"),
    # EPH markers after the packet headers, the headers packed into PPT / PPM
    # (the packets located by reading their headers, checked against PLT)
    "eph": lambda: j2k_with_eph(*_located(_many_packets())),
    "ppt": lambda: j2k_with_packed_headers(*_located(_many_packets()), "ppt"),
    "ppm": lambda: j2k_with_packed_headers(*_located(_many_packets(irreversible=True)), "ppm"),
    "ppt-sop": lambda: j2k_with_packed_headers(*_located(j2k_with_sop(_many_packets())), "ppt"),
    # POC: RLCP split at resolution 2; the same packets as RLCP after a COD
    # saying LRCP; a PCRL entry and an RLCP one
    "poc-split": lambda: _with_segment(
        pil_bytes(image("RGB", 11), no_jp2=True, progression="RLCP", quality_layers=[20, 8, 3],
                  num_resolutions=4), 0xFF5F, _poc((0, 0, 3, 2, 3, 1), (2, 0, 3, 4, 3, 1))),
    "poc-overrides-cod": lambda: _with_segment(
        _cod(pil_bytes(image("L", 12), no_jp2=True, progression="RLCP", quality_layers=[20, 8]),
             lambda b: b[:1] + b"\x00" + b[2:]), 0xFF5F, _poc((0, 0, 2, 33, 1, 1))),
    "poc-in-tile": lambda: _with_segment(
        pil_bytes(image("LA", 13), no_jp2=True, progression="PCRL", precinct_size=(16, 16),
                  num_resolutions=3, quality_layers=[20, 8]), 0xFF5F, _poc((0, 0, 2, 33, 2, 3)),
        tile=True),
    # JP2 box layouts
    "jp2-xlbox-res-cdef": lambda: jp2_bytes(
        pil_bytes(image("RGBA", 14), no_jp2=True, mct=1), 4, 7, 16,
        header_boxes=[(b"res ", struct.pack(">I4sHHHHBB", 18, b"resc", 72, 1, 72, 1, 0, 0)),
                      (b"cdef", struct.pack(">H12H", 4, 0, 0, 1, 1, 0, 2, 2, 0, 3, 3, 1, 0))],
        boxes=[(b"xml ", b"<x/>")], long_codestream_box=True),
    "jp2-to-end": lambda: jp2_bytes(pil_bytes(image("I;16", 15), no_jp2=True), 1, 15,
                                    codestream_to_end=True),
    "jp2-gray-la": lambda: jp2_bytes(pil_bytes(image("LA", 16), no_jp2=True), 2, 7,
                                     boxes=[(b"uuid", bytes(20))]),
    # a palette: P, PIL's palette holding each new colour once; with a bit
    # depth byte above 8 none (the indices read as L)
    "jp2-palette": lambda: jp2_bytes(pil_bytes(image("L", 19), no_jp2=True), 1, 7, 16,
                                     header_boxes=[(b"pclr", _pclr(200, 3)), (b"cmap", _CMAP)]),
    "jp2-palette-9-bit-entries": lambda: jp2_bytes(
        pil_bytes(image("L", 20), no_jp2=True), 1, 7, 17,
        header_boxes=[(b"pclr", _pclr(3, 3, depth_byte=9)), (b"cmap", _CMAP)]),
    # a colour space PIL guesses from the component count: an ICC profile,
    # an enumeration PIL and OpenJPEG do not know
    "jp2-icc-rgb": lambda: jp2_bytes(_CS(32), 3, 7, colr=b"\x02\0\0" + bytes(128)),
    "jp2-enumcs-20-gray": lambda: jp2_bytes(pil_bytes(image("L", 33), no_jp2=True), 1, 7, 20),
    # subsampled components at PIL's indices (odd sizes: its integer
    # divisions misplace the later components' rows); sYCC guessed for
    # subsampled chroma (components 1 or 2) in a codestream or a JP2 without
    # an enumerated colour space, not for an sRGB JP2, a subsampled first
    # component or a subsampled alpha alone
    "subsampled-420": lambda: _subsampled([(1, 1), (2, 2), (2, 2)], (32, 40)),
    "subsampled-odd-irreversible": lambda: _subsampled([(1, 1), (2, 1), (1, 3)], seed=1,
                                                       irreversible=True),
    "subsampled-all": lambda: _subsampled([(2, 2), (2, 2), (3, 2)], seed=2),
    "subsampled-rgba": lambda: _subsampled([(1, 1), (2, 2), (2, 2), (1, 1)], seed=3),
    "subsampled-alpha-only": lambda: _subsampled([(1, 1), (1, 1), (1, 1), (2, 3)], seed=9),
    # a tile or an image starting on an odd row: PIL reads a row of the last
    # component past OpenJPEG's data, in the zeros of its tile buffer
    "subsampled-420-tiles": lambda: _subsampled([(1, 1), (2, 2), (2, 2)], (66, 48), seed=6,
                                                tile=(32, 33)),
    "subsampled-420-offset": lambda: _subsampled([(1, 1), (2, 2), (2, 2)], (33, 40), seed=7,
                                                 offset=(0, 1)),
    "subsampled-rgba-tiles-offset": lambda: _subsampled(
        [(1, 1), (2, 3), (3, 2), (1, 1)], (49, 45), seed=8, tile=(30, 25), offset=(3, 1)),
    "jp2-subsampled-srgb": lambda: jp2_bytes(_subsampled([(1, 1), (2, 2), (2, 2)], seed=4),
                                             3, 7, 16),
    "jp2-subsampled-guess": lambda: jp2_bytes(_subsampled([(1, 1), (3, 1), (1, 3)], seed=5),
                                              3, 7, 0),
    # CMYK: four components as they are
    "jp2-cmyk": lambda: jp2_bytes(pil_bytes(image("RGBA", 23), no_jp2=True), 4, 7, 12),
    # sYCC: PIL converts the components with its YCbCr -> RGB tables
    "jp2-sycc-rgb": lambda: jp2_bytes(pil_bytes(image("RGB", 17), no_jp2=True), 3, 7, 18),
    "jp2-sycc-rgba-noise": lambda: jp2_bytes(pil_bytes(Image.fromarray(
        np.random.default_rng(18).integers(0, 256, (48, 60, 4), dtype=np.uint8), "RGBA"),
        no_jp2=True, irreversible=True, mct=1), 4, 7, 18),
}


@pytest.mark.parametrize("variant", sorted(REWRITES))
def test_rewritten_jpeg2000_reads_as_jax(tmp_path, variant):
    blob = REWRITES[variant]()
    assert_reads_as_jax(write(tmp_path, "x.jp2" if blob[:4] == b"\0\0\0\x0c" else "x.j2k", blob))


_CS = lambda seed=20, **kw: pil_bytes(image("RGB", seed), no_jp2=True, mct=1, **kw)  # noqa: E731

# features PIL's writer cannot produce and the port refuses (ROADMAP.md
# Queue 3): variant -> (file, the feature the message names)
REFUSED = {
    "code-block-style": (lambda: _cod(_CS(), lambda b: b[:8] + b"\x01" + b[9:]),
                         "code-block style 0x01"),
    "htj2k-code-blocks": (lambda: _cod(_CS(), lambda b: b[:8] + b"\x40" + b[9:]),
                          r"HTJ2K \(Part 15\)"),
    "htj2k-rsiz": (lambda: (lambda c: c[:6] + b"\x40\x00" + c[8:])(_CS()), r"HTJ2K \(Part 15\)"),
    "rgn-style-1": (lambda: _with_segment(_CS(), 0xFF5E, b"\x00\x01\x03"),
                    "region of interest style 1"),
    "subsampled-la": (lambda: _subsampled([(1, 1), (2, 2)]),
                      "a subsampled component in mode LA"),
    "32-bit": (lambda: _siz_precision(_CS(), 32, False), "a precision above 31 bits"),
    "palette-with-alpha": (lambda: jp2_bytes(pil_bytes(image("LA", 21), no_jp2=True), 2, 7, 16,
                                             header_boxes=[(b"pclr", _pclr(4, 3))]),
                           r"a palette with alpha \(PA\)"),
    "palette-rgba": (lambda: jp2_bytes(pil_bytes(image("L", 21), no_jp2=True), 1, 7, 16,
                                       header_boxes=[(b"pclr", _pclr(4, 4))]),
                     "a palette of 4 components"),
    "e-sycc": (lambda: jp2_bytes(_CS(24), 3, 7, 24), "the e-sYCC colour space"),
}


@pytest.mark.parametrize("variant", sorted(REFUSED))
def test_refused_jpeg2000_raises_naming_the_file_and_feature(tmp_path, variant):
    make, feature = REFUSED[variant]
    path = write(tmp_path, f"{variant}.jp2", make())
    for read in (tds.load_gray, tds.load_depth, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match=f"JPEG 2000: {feature} is not supported") as err:
            read(path)
        assert path in str(err.value)


# ---- the tum_jp2 folder of test_data/torch_io -----------------------------------------------

def test_tum_jp2_folder_reads_as_jax():
    seq = os.path.join(FIXTURES, "tum_jp2")
    got_t, got_j = list(tds.iter_tum_rgbd(seq)), list(jds.iter_tum_rgbd(seq))
    assert len(got_t) == len(got_j) == 2
    icl = os.path.join(REPO, "test_data", "icl")
    for i, (a, b) in enumerate(zip(got_t, got_j)):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.intensity, b.intensity)
        np.testing.assert_array_equal(a.depth, b.depth)
        # lossless: the PGM's depth (in one tile column, which PIL's writer
        # keeps in place for I;16)
        pgm = jds.load_depth(os.path.join(icl, f"image_depth_{i}.pgm"))
        np.testing.assert_array_equal(a.depth, pgm)


def test_rgbd_over_the_tum_jp2_folder_matches_jax():
    seq = os.path.join(FIXTURES, "tum_jp2")
    t_frames, j_frames = list(tds.iter_tum_rgbd(seq)), list(jds.iter_tum_rgbd(seq))
    got = _port_run([(f.intensity, f.depth) for f in t_frames], tds.icl_camera(),
                    frontend.adapt_rgbd, frontend.DepthAdaptorConfig(), "rgbd")
    want = _jax_run([(f.intensity, f.depth) for f in j_frames], jds.icl_camera(),
                    jfe.adapt_rgbd, jfe.DepthAdaptorConfig(), "rgbd")
    counts = _assert_runs_equal(got, want)
    assert counts[1]["num_inliers"] > 30
