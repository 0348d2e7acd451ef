"""TIFF through the port's readers, to the bit as the JAX package reads it
through PIL (libtiff for compressed files), on the CPU.

Files are written at test time from seeded arrays: by PIL where PIL writes
the variant (LZW / Deflate / PackBits / Zstandard strips, horizontal
differencing through ``tiffinfo``), by ``tests/torch_imagefiles.py::tiff_bytes``
elsewhere (tiles, big-endian files, planar configuration 2, the float
predictor, the layouts PIL does not save, Zstandard frames of libzstd's
levels -5 to 22 with and without the content checksum).  Bounds, every case: the port's
``load_gray`` and ``load_depth`` equal the JAX package's to the bit, the
library's samples, mode and palette equal its plain twin's, the mode is
PIL's; refused variants raise a ``ValueError`` naming the file and the
feature.  The KITTI- and TUM-layout TIFF folders of ``test_data/torch_io``
(and the KITTI-layout Zstandard one) read frame for frame as the JAX
package reads them, and as the PNG / PGM frames they were made from, and
VO and RGB-D over them run alike in both
packages: ``adapt_stereo -> track_step`` over ``kitti_tiff/`` and
``adapt_rgbd -> track_step(model="rgbd")`` over ``tum_tiff/``, each
package reading the folder through its own reader, with the adaptor's
points / desc / valid bit-exact, measurements, matches, inliers, merges
and additions equal per frame and the poses within 5e-4 of JAX's (the
bound of ``tests/test_torch_rgbd.py``): the path ``chip_smoke.py`` phase
8g drives on the card.
"""
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)

from srrg2_proslam_tpu.io import datasets as jds  # noqa: E402
from srrg2_proslam_tpu.models import frontend as jfe, tracker as jtr  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets as tds  # noqa: E402
from srrg2_proslam_tpu_torch.io import images, images_plain  # noqa: E402
from srrg2_proslam_tpu_torch.models import frontend, tracker  # noqa: E402
from torch_imagefiles import tiff_bytes, zstd_frame, zstd_match_frame  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
FIXTURES = os.path.join(REPO, "test_data", "torch_io")
H, W = 21, 37


def samples(seed: int, n: int, bits: int, signed: bool = False, flt: bool = False):
    rng = np.random.default_rng(seed)
    if flt:
        a = rng.normal(100, 120, (H, W, n)).astype(np.float32)
        a[0, :3, 0] = (np.nan, np.inf, -np.inf)
        return a
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits)
    return rng.integers(lo, hi, (H, W, n), dtype=np.int64)


def assert_reads_as_jax(path: str):
    mode = Image.open(path).mode
    lib, plain = images.decode(path), images_plain.decode(path)
    assert lib.mode == plain.mode == mode
    assert lib.samples.dtype == plain.samples.dtype and lib.samples.shape == plain.samples.shape
    np.testing.assert_array_equal(lib.samples, plain.samples)
    if lib.mode == "P":
        np.testing.assert_array_equal(lib.palette, plain.palette)
    for name in ("load_gray", "load_depth"):
        got, want = getattr(tds, name)(path), getattr(jds, name)(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# (name, samples, bits, photometric, writer keywords)
LAYOUTS = {
    "gray8": (lambda: samples(1, 1, 8), 8, 1, {}),
    "gray8-miniswhite": (lambda: samples(2, 1, 8), 8, 0, {}),
    "bilevel": (lambda: samples(3, 1, 1), 1, 1, {}),
    "bilevel-miniswhite": (lambda: samples(4, 1, 1), 1, 0, {}),
    "gray2": (lambda: samples(5, 1, 2), 2, 1, {}),
    "gray4-miniswhite": (lambda: samples(6, 1, 4), 4, 0, {}),
    "u16": (lambda: samples(7, 1, 16), 16, 1, {}),
    "u16-miniswhite": (lambda: samples(8, 1, 16), 16, 0, {}),
    "i16": (lambda: samples(9, 1, 16, signed=True), 16, 1, dict(sample_format=2)),
    "u32": (lambda: samples(10, 1, 32), 32, 1, {}),
    "i32": (lambda: samples(11, 1, 32, signed=True), 32, 1, dict(sample_format=2)),
    "f32": (lambda: samples(12, 1, 32, flt=True), 32, 1, dict(sample_format=3)),
    "gray-alpha": (lambda: samples(13, 2, 8), 8, 1, dict(extra=(2,))),
    "rgb": (lambda: samples(14, 3, 8), 8, 2, {}),
    "rgba": (lambda: samples(15, 4, 8), 8, 2, dict(extra=(2,))),
    "rgba-associated": (lambda: samples(16, 4, 8), 8, 2, dict(extra=(1,))),
    "rgbx": (lambda: samples(17, 4, 8), 8, 2, dict(extra=(0,))),
    "rgb16": (lambda: samples(18, 3, 16), 16, 2, {}),
    "cmyk": (lambda: samples(19, 4, 8), 8, 5, {}),
    "palette4": (lambda: samples(20, 1, 4), 4, 3,
                 dict(colormap=np.random.default_rng(0).integers(0, 65536, (3, 16)))),
    "palette8": (lambda: samples(21, 1, 8), 8, 3,
                 dict(colormap=np.random.default_rng(1).integers(0, 65536, (3, 256)))),
}
# (layout, compression, big-endian, organisation)
# two cases per layout, rotating the compression, byte order and organisation
CASES = [(name, comp, be, org)
         for i, name in enumerate(LAYOUTS)
         for comp, be, org in [((1, 5, 8, 32773)[i % 4], i % 2 == 1,
                                ("strips", "tiles")[i % 3 == 0]),
                               ((5, 8, 32773, 1)[i % 4], i % 2 == 0,
                                ("strips", "tiles")[i % 3 != 0])]
         if not (be and name in ("u16-miniswhite", "u32"))]   # PIL reads neither big-endian


@pytest.mark.parametrize("name,compression,big_endian,org", CASES,
                         ids=[f"{n}-c{c}-{'be' if b else 'le'}-{o}" for n, c, b, o in CASES])
def test_tiff_layout_reads_as_jax(tmp_path, name, compression, big_endian, org):
    make, bits, photo, kw = LAYOUTS[name]
    org_kw = dict(tile=(16, 16)) if org == "tiles" else dict(rows_per_strip=8)
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(make(), bits, photo, compression=compression, big_endian=big_endian,
                           **org_kw, **kw))
    assert_reads_as_jax(path)


# horizontal differencing and the float predictor, planar configuration 2
PREDICTOR_CASES = [
    ("gray8", 2, 5, False, {}), ("u16", 2, 8, True, {}), ("i32", 2, 5, True, {}),
    ("rgb", 2, 8, False, {}), ("rgb16", 2, 5, True, {}),
    ("f32", 3, 8, False, dict(tile=(16, 32))), ("f32", 3, 5, True, {}),
    ("rgb", 1, 5, False, dict(planar=2)), ("rgba", 2, 8, True, dict(planar=2, tile=(16, 16))),
    ("cmyk", 1, 1, False, dict(planar=2)),
]


@pytest.mark.parametrize("name,predictor,compression,big_endian,kw", PREDICTOR_CASES,
                         ids=[f"{n}-pred{p}-c{c}-{'be' if b else 'le'}"
                              f"{'-planar2' if k.get('planar') else ''}"
                              for n, p, c, b, k in PREDICTOR_CASES])
def test_tiff_predictor_and_planar_read_as_jax(tmp_path, name, predictor, compression,
                                               big_endian, kw):
    make, bits, photo, layout_kw = LAYOUTS[name]
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(make(), bits, photo, compression=compression, predictor=predictor,
                           big_endian=big_endian, rows_per_strip=kw.pop("rows", 7),
                           **layout_kw, **kw))
    assert_reads_as_jax(path)


PIL_CASES = [("L", "raw", {}), ("L", "tiff_lzw", {317: 2}), ("L", "tiff_adobe_deflate", {}),
             ("L", "packbits", {278: 5}), ("I;16", "tiff_lzw", {317: 2}), ("F", "raw", {}),
             ("RGB", "tiff_deflate", {317: 2}), ("RGBA", "tiff_lzw", {}), ("1", "raw", {}),
             ("P", "tiff_lzw", {}), ("CMYK", "packbits", {}), ("I;16B", "raw", {}),
             # Zstandard (libtiff's ZSTD codec, compression 50000)
             ("L", "zstd", {}), ("L", "zstd", {317: 2, 278: 6}), ("I;16", "zstd", {317: 2}),
             ("F", "zstd", {317: 3}), ("F", "zstd", {}), ("RGB", "zstd", {317: 2}),
             ("RGBA", "zstd", {278: 4}), ("1", "zstd", {}), ("P", "zstd", {}),
             ("CMYK", "zstd", {317: 2})]


@pytest.mark.parametrize("mode,compression,info", PIL_CASES,
                         ids=[f"{m}-{c}-{'-'.join(map(str, i))}" for m, c, i in PIL_CASES])
def test_tiff_written_by_pil_reads_as_jax(tmp_path, mode, compression, info):
    rng = np.random.default_rng(len(mode) + len(compression))
    if mode in ("I;16", "I;16B"):
        img = Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16))
        if mode == "I;16B":
            img = img.convert("I;16B")
    elif mode == "F":
        img = Image.fromarray(rng.normal(80, 90, (H, W)).astype(np.float32))
    elif mode == "P":
        img = Image.fromarray(rng.integers(0, 256, (H, W)).astype(np.uint8), "P")
        img.putpalette(list(rng.integers(0, 256, 768)))
    else:
        bands = {"L": 1, "1": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
        arr = rng.integers(0, 256, (H, W, bands)).astype(np.uint8)
        img = Image.fromarray(arr[:, :, 0] if bands == 1 else arr,
                              None if mode == "1" else mode)
        if mode == "1":
            img = img.convert("1")
    path = str(tmp_path / "x.tiff")
    img.save(path, compression=compression, tiffinfo=info)
    assert_reads_as_jax(path)


# Zstandard strips and tiles written by libzstd's encoder (the zstandard
# package): levels from -5 (raw literals, few sequences) to 22 (Huffman
# literals in four streams, FSE-compressed tables, repeat offsets), the
# content checksum, no content size, a skippable frame after the data, an
# incompressible strip (raw blocks), a constant one (RLE blocks)
ZSTD_CASES = [
    ("gray8", 2, dict(tile=(16, 16)), dict(level=19, checksum=True)),
    ("u16", 2, dict(rows_per_strip=5), dict(level=-5)),
    ("f32", 3, dict(tile=(32, 16)), dict(level=9, checksum=True, content_size=False)),
    ("rgb", 1, dict(planar=2, rows_per_strip=8), dict(level=1, skippable=b"extra")),
    ("rgb16", 2, dict(tile=(16, 32)), dict(level=12)),
    ("i32", 2, dict(rows_per_strip=11), dict(level=22, checksum=True)),
    ("rgba", 2, {}, dict(level=3)),
    ("noise8", 1, {}, dict(level=3)),
    ("flat8", 1, dict(rows_per_strip=4), dict(level=3, checksum=True)),
]


@pytest.mark.parametrize("name,predictor,org,zkw", ZSTD_CASES,
                         ids=[f"{n}-pred{p}-" + "-".join(f"{k}={v}" for k, v in {**o, **z}.items())
                              for n, p, o, z in ZSTD_CASES])
def test_zstd_tiff_strips_and_tiles_read_as_jax(tmp_path, name, predictor, org, zkw):
    if name == "noise8":
        arr, bits, photo, kw = samples(30, 1, 8), 8, 1, {}
    elif name == "flat8":
        arr, bits, photo, kw = np.full((H, W, 1), 77), 8, 1, {}
    else:
        make, bits, photo, kw = LAYOUTS[name]
        arr = make()
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(arr, bits, photo, compression=50000, predictor=predictor,
                           codec=zstd_frame(**zkw), **org, **kw))
    assert_reads_as_jax(path)


def _zstd_refused(variant: str) -> bytes:
    if variant in ("skippable-first", "bad-checksum"):
        def codec(data):
            frame = zstd_frame(checksum=True)(data)
            if variant == "skippable-first":
                return struct.pack("<II", 0x184D2A50, 3) + b"abc" + frame
            return frame[:-4] + bytes(b ^ 0xFF for b in frame[-4:])
        return tiff_bytes(samples(31, 1, 8), 8, 1, compression=50000, codec=codec)
    frame = {"block-above-128k": lambda: zstd_match_frame(20, 100),
             "block-above-window": lambda: zstd_match_frame(10, 1, 0),
             "window-above-128mib": lambda: zstd_match_frame(28, 1, 0),
             "short-of-content-size": lambda: zstd_match_frame(20, 1, 0, 65541)}[variant]()
    return tiff_bytes(np.zeros((128, 512, 1)), 8, 1, compression=50000, codec=lambda _: frame)


@pytest.mark.parametrize("variant,reason", [
    ("skippable-first", "not enough ZSTD data"), ("bad-checksum", "ZSTD checksum mismatch"),
    ("block-above-128k", "a block above its maximum"),
    ("block-above-window", "a block above its maximum"),
    ("window-above-128mib", "a window above 128 MiB"),
    ("short-of-content-size", "less data than the content size")])
def test_zstd_tiff_libtiff_refuses_is_refused(tmp_path, variant, reason):
    """libtiff stops at the end of the first frame (a skippable frame first
    leaves the strip short) and checks the content checksum; libzstd refuses
    a block regenerating more than 128 KiB or its window (the first one
    here would make 13 MB), a window above 128 MiB and a frame short of its
    content size."""
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as f:
        f.write(_zstd_refused(variant))
    with pytest.raises(OSError):
        Image.open(path).load()
    for read in (tds.load_gray, tds.load_depth, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match=reason) as err:
            read(path)
        assert path in str(err.value)


def _patched(blob: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with ``tag`` (one SHORT) set or added."""
    ifd = int.from_bytes(blob[4:8], "little")
    n = int.from_bytes(blob[ifd:ifd + 2], "little")
    out = bytearray(blob)
    for i in range(n):
        at = ifd + 2 + 12 * i
        if int.from_bytes(blob[at:at + 2], "little") == tag:
            out[at + 8:at + 10] = value.to_bytes(2, "little")
            return bytes(out)
    raise KeyError(tag)


# Since the TIFF slice's successor reads fill order 2, orientations 2-8,
# JPEG, YCbCr, little-endian 12-bit, LAB, 16-bit planar configuration 2 and
# BigTIFF, these cases hold the refusals that remain under each name: a
# fill-order-2 layout PIL has no mode for, WebP compression (libtiff here
# has none), a compression-7 strip that is no JPEG, uncompressed YCbCr
# (PIL reads it as RGBX and runs out of data), big-endian 12-bit, 16-bit
# LAB, 16-bit gray + alpha in planes, a BigTIFF without dimensions.
REFUSED = {
    "fill-order-2": (lambda: tiff_bytes(samples(15, 4, 8), 8, 2, extra=(2,),
                                        tags=[(266, 3, [2])]), "fill order 2"),
    "orientation-6": (lambda: _patched(tiff_bytes(samples(1, 1, 8), 8, 1, tags=[(274, 3, [6])]),
                                       259, 50001), "compression 50001"),
    "jpeg-compression": (lambda: _patched(tiff_bytes(samples(1, 1, 8), 8, 1), 259, 7),
                         "compression 7"),
    "ycbcr": (lambda: tiff_bytes(samples(1, 3, 8), 8, 6), "photometric 6"),
    "12-bit": (lambda: tiff_bytes(samples(1, 1, 12), 16, 1, big_endian=True).replace(
        b"\x01\x02\x00\x03\x00\x00\x00\x01\x00\x10", b"\x01\x02\x00\x03\x00\x00\x00\x01\x00\x0c"),
        "12-bit"),
    "big-endian-u32": (lambda: tiff_bytes(samples(10, 1, 32), 32, 1, big_endian=True),
                       "32-bit samples"),
    "lab": (lambda: tiff_bytes(samples(1, 3, 16), 16, 8), "photometric 8"),
    "planar-2-16-bit": (lambda: tiff_bytes(samples(1, 2, 16), 16, 1, extra=(2,), planar=2),
                        "planar configuration 2"),
    "bigtiff": (lambda: b"II+\0\x08\0\0\0" + (16).to_bytes(8, "little") + bytes(16),
                "BigTIFF"),
}


@pytest.mark.parametrize("variant", sorted(REFUSED))
def test_refused_tiff_raises_naming_the_file(tmp_path, variant):
    make, reason = REFUSED[variant]
    path = str(tmp_path / f"{variant}.tif")
    with open(path, "wb") as f:
        f.write(make())
    with pytest.raises((OSError, SyntaxError, ValueError)):   # PIL refuses each too
        Image.open(path).load()
    for read in (tds.load_gray, tds.load_depth, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match=reason) as err:
            read(path)
        assert path in str(err.value)


# ---- the TIFF folders of test_data/torch_io --------------------------------------

def test_kitti_tiff_folder_reads_as_jax_and_as_the_png_frames():
    seq = os.path.join(FIXTURES, "kitti_tiff")
    got_t = list(tds.iter_kitti_odometry(seq))
    got_j = list(jds.iter_kitti_odometry(seq))
    assert len(got_t) == len(got_j) == 2
    kitti = os.path.join(REPO, "test_data", "kitti", "city")
    for i, (a, b) in enumerate(zip(got_t, got_j)):
        assert a.timestamp == b.timestamp
        for side in ("left", "right"):
            np.testing.assert_array_equal(getattr(a, side), getattr(b, side))
            png = jds.load_gray(os.path.join(kitti, f"image_{side}_{i}.png"))[:, 300:940]
            np.testing.assert_array_equal(getattr(a, side), png)


def test_kitti_zstd_folder_reads_as_jax_and_as_the_png_frames():
    seq = os.path.join(FIXTURES, "kitti_zstd")
    got_t = list(tds.iter_kitti_odometry(seq))
    got_j = list(jds.iter_kitti_odometry(seq))
    assert len(got_t) == len(got_j) == 2
    kitti = os.path.join(REPO, "test_data", "kitti", "city")
    for i, (a, b) in enumerate(zip(got_t, got_j)):
        assert a.timestamp == b.timestamp
        for side in ("left", "right"):
            np.testing.assert_array_equal(getattr(a, side), getattr(b, side))
            png = jds.load_gray(os.path.join(kitti, f"image_{side}_{i}.png"))[:, 300:940]
            np.testing.assert_array_equal(getattr(a, side), png)


def test_tum_tiff_folder_reads_as_jax_and_as_the_icl_frames():
    seq = os.path.join(FIXTURES, "tum_tiff")
    got_t = list(tds.iter_tum_rgbd(seq))
    got_j = list(jds.iter_tum_rgbd(seq))
    assert len(got_t) == len(got_j) == 2
    icl = os.path.join(REPO, "test_data", "icl")
    for i, (a, b) in enumerate(zip(got_t, got_j)):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.intensity, b.intensity)
        np.testing.assert_array_equal(a.depth, b.depth)
        gray = Image.open(os.path.join(icl, f"image_rgb_{i}.png")).convert("L")
        np.testing.assert_array_equal(a.intensity, np.asarray(gray, np.float32))
        np.testing.assert_array_equal(
            a.depth, jds.load_depth(os.path.join(icl, f"image_depth_{i}.pgm")))


# ---- VO and RGB-D over the TIFF folders, in both packages ---------------------------

CAPACITY = 4096
COUNTS = ("num_measurements", "num_matches", "num_inliers", "num_merges", "num_additions")


def _jax_run(pairs, cam, adapt, cfg, model):
    state = jtr.initial_state(capacity=CAPACITY)
    out = []
    for a, b in pairs:
        meas = adapt(jnp.asarray(a), jnp.asarray(b), cfg)
        state, stats, _ = jtr.track_step(state, meas.points, meas.desc, meas.valid, cam,
                                         jtr.TrackerConfig(), model)
        jax.block_until_ready(state)
        out.append(([np.asarray(t) for t in meas], {k: int(getattr(stats, k)) for k in COUNTS},
                    np.asarray(state.T_lm_robot)))
    return out


def _port_run(pairs, cam, adapt, cfg, model):
    state = tracker.initial_state(capacity=CAPACITY, device="cpu")
    out = []
    for a, b in pairs:
        meas = adapt(torch.from_numpy(a), torch.from_numpy(b), cfg)
        state, stats, _ = tracker.track_step(state, meas.points, meas.desc, meas.valid, cam,
                                             tracker.TrackerConfig(), model)
        out.append(([t.numpy() for t in meas], {k: int(getattr(stats, k)) for k in COUNTS},
                    state.T_lm_robot.numpy()))
    return out


def _assert_runs_equal(got, want):
    assert len(got) == len(want) == 2
    for i, ((g_meas, g_counts, g_pose), (w_meas, w_counts, w_pose)) in enumerate(
            zip(got, want)):
        for name, g, w in zip(("points", "desc", "valid"), g_meas, w_meas):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"frame {i} {name}")
        assert g_counts == w_counts, (i, g_counts, w_counts)
        np.testing.assert_allclose(g_pose, w_pose, atol=5e-4, err_msg=f"frame {i}")
    return [c for _, c, _ in got]


def test_stereo_vo_over_the_kitti_tiff_folder_matches_jax():
    seq = os.path.join(FIXTURES, "kitti_tiff")
    t_frames, j_frames = list(tds.iter_kitti_odometry(seq)), list(jds.iter_kitti_odometry(seq))
    got = _port_run([(f.left, f.right) for f in t_frames],
                    tds.kitti_camera(*t_frames[0].left.shape), frontend.adapt_stereo,
                    frontend.StereoAdaptorConfig(), "stereo")
    want = _jax_run([(f.left, f.right) for f in j_frames],
                    jds.kitti_camera(*j_frames[0].left.shape), jfe.adapt_stereo,
                    jfe.StereoAdaptorConfig(), "stereo")
    counts = _assert_runs_equal(got, want)
    assert counts[1]["num_inliers"] > 50


def test_rgbd_over_the_tum_tiff_folder_matches_jax():
    seq = os.path.join(FIXTURES, "tum_tiff")
    t_frames, j_frames = list(tds.iter_tum_rgbd(seq)), list(jds.iter_tum_rgbd(seq))
    got = _port_run([(f.intensity, f.depth) for f in t_frames], tds.icl_camera(),
                    frontend.adapt_rgbd, frontend.DepthAdaptorConfig(), "rgbd")
    want = _jax_run([(f.intensity, f.depth) for f in j_frames], jds.icl_camera(),
                    jfe.adapt_rgbd, jfe.DepthAdaptorConfig(), "rgbd")
    counts = _assert_runs_equal(got, want)
    assert counts[1]["num_inliers"] > 30


CHILD = r"""
import hashlib, json, sys
for name in ("jax", "jaxlib", "srrg2_proslam_tpu", "PIL"):
    sys.modules[name] = None
from srrg2_proslam_tpu_torch.io import datasets
manifest = json.load(open("test_data/torch_io/MANIFEST.json"))
for name in ("kitti_tiff/image_0/000001.tif", "tum_tiff/depth/1.tif",
             "kitti_zstd/image_0/000001.tif", "tum_jp2/rgb/1.jp2", "tum_jp2/depth/1.j2k"):
    for fn in ("load_gray", "load_depth"):
        arr = getattr(datasets, fn)("test_data/torch_io/" + name)
        assert hashlib.sha256(arr.tobytes()).hexdigest() == manifest[name][fn + "_sha256"]
print("decoded without jax and PIL")
"""


def test_port_reads_tiff_without_jax_or_pil():
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "decoded without jax and PIL"
