"""The port reads and writes every image file the JAX package does, to the
bit, on the CPU.

The JAX package's ``load_gray`` / ``load_depth`` take PIL wherever its
native decoder refuses a file; the port takes its second image library
(``io/images.py``, C++ built with g++) there, and
``io/images_plain.py`` is that library's plain Python twin.  The files are
written at test time from arrays made from a seed: by PIL where PIL writes
the format (JPEG gray, 4:4:4, 4:2:2, 4:2:0 and RGB-coded, baseline and
progressive, at quality 50/75/95, with restart markers; palette PNG at 1/2/4/8 bits; 1-bit
PNG; BMP), by ``tests/torch_imagefiles.py`` where it does not (4:1:1 and
4:4:0 JPEG: PIL's "4:1:1" is 4:2:0; 2/4-bit gray PNG and Adam7 PNG), plus
the committed fixtures of ``test_data/torch_io/`` against their manifest.
Bounds, every case: the port's ``load_gray`` and ``load_depth`` equal to
the JAX package's to the bit; the library's samples, mode and palette equal
to the twin's; ``save_gray`` to ``.jpg`` / ``.jpeg`` / ``.bmp`` / ``.tif`` /
``.tiff`` / ``.gif`` / ``.pfm`` byte-identical with PIL's file for the same
array (TIFF, GIF, PNM and PFM reading: ``test_torch_imageio_tiff.py`` and
``test_torch_imageio_more.py``).
"""
import hashlib
import io
import json
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from srrg2_proslam_tpu.io import boss as jboss, datasets as jds  # noqa: E402

from srrg2_proslam_tpu_torch.io import boss as tboss, datasets as tds  # noqa: E402
from srrg2_proslam_tpu_torch.io import images, images_plain  # noqa: E402
from torch_imagefiles import (jpeg_arith_bytes, jpeg_color_bytes,  # noqa: E402
                              jpeg_lossless_bytes, png_bytes)

REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
FIXTURES = os.path.join(REPO, "test_data", "torch_io")
with open(os.path.join(FIXTURES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)
KITTI = os.path.join(REPO, "test_data", "kitti", "city")


def _image(seed: int, h: int, w: int, c: int) -> np.ndarray:
    """A smooth pattern with noise, uint8 [h, w, c]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 6.0 + k) * np.cos(y / 5.0 - k) for k in range(c)],
                    -1)
    return np.clip(base + rng.normal(0, 18, (h, w, c)), 0, 255).astype(np.uint8)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.float32).tobytes()).hexdigest()


def _assert_port_equals_jax(path: str):
    for name in ("load_gray", "load_depth"):
        got, want = getattr(tds, name)(path), getattr(jds, name)(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_library_equals_twin(path: str):
    lib, plain = images.decode(path), images_plain.decode(path)
    assert (lib.mode, lib.samples.dtype, lib.samples.shape) == (
        plain.mode, plain.samples.dtype, plain.samples.shape)
    np.testing.assert_array_equal(lib.samples, plain.samples)
    if lib.mode == "P":
        np.testing.assert_array_equal(lib.palette, plain.palette)


# ---- JPEG ----------------------------------------------------------------------

# (sampling, quality, progressive, restart: 0 none / 1 every MCU / 2 every MCU row, (h, w))
JPEG_CASES = [
    ("gray", 50, False, 0, (37, 53)), ("gray", 75, True, 0, (37, 53)),
    ("gray", 95, False, 1, (16, 24)), ("gray", 95, True, 2, (5, 3)),
    ("4:4:4", 50, False, 0, (37, 53)), ("4:4:4", 95, True, 0, (21, 30)),
    ("4:4:4", 75, True, 1, (9, 17)),
    ("4:2:2", 50, False, 0, (37, 53)), ("4:2:2", 75, True, 2, (23, 41)),
    ("4:2:2", 95, False, 0, (3, 2)),
    ("4:2:0", 50, True, 0, (37, 53)), ("4:2:0", 75, False, 1, (33, 47)),
    ("4:2:0", 95, True, 0, (17, 31)), ("4:2:0", 75, False, 0, (1, 1)),
    ("4:1:1", 75, False, 0, (37, 53)), ("4:1:1", 95, False, 0, (9, 5)),
    ("4:4:0", 75, False, 0, (19, 29)),
    ("rgb", 75, False, 0, (19, 23)), ("rgb", 90, True, 0, (16, 16)),   # Adobe transform 0
]
OWN_SAMPLING = {"4:1:1": ((4, 1), (1, 1), (1, 1)), "4:4:0": ((1, 2), (1, 1), (1, 1))}


@pytest.mark.parametrize("sampling,quality,progressive,restart,size", JPEG_CASES,
                         ids=[f"{s}-q{q}-{'prog' if p else 'base'}-rst{r}-{h}x{w}"
                              for s, q, p, r, (h, w) in JPEG_CASES])
def test_jpeg_equals_jax(tmp_path, sampling, quality, progressive, restart, size):
    seed = quality + 7 * size[0] + size[1]
    path = str(tmp_path / "x.jpg")
    if sampling in OWN_SAMPLING:
        with open(path, "wb") as f:
            f.write(jpeg_color_bytes(_image(seed, *size, 3), OWN_SAMPLING[sampling], quality))
    else:
        arr = _image(seed, *size, 1 if sampling == "gray" else 3)
        img = Image.fromarray(arr[:, :, 0]) if sampling == "gray" else Image.fromarray(arr)
        kw = {"quality": quality, "progressive": progressive}
        if sampling == "rgb":
            kw["keep_rgb"] = True
        elif sampling != "gray":
            kw["subsampling"] = sampling
        if restart:
            kw["restart_marker_blocks" if restart == 1 else "restart_marker_rows"] = 1
        img.save(path, **kw)
    assert Image.open(path).mode == ("L" if sampling == "gray" else "RGB")
    _assert_port_equals_jax(path)
    _assert_library_equals_twin(path)


# ---- PNG -----------------------------------------------------------------------

# (kind, bit depth, Adam7)
PNG_CASES = [("palette", 1, False), ("palette", 2, False), ("palette", 4, False),
             ("palette", 8, False), ("bilevel", 1, False), ("gray", 2, False),
             ("gray", 4, False), ("gray", 1, True), ("gray", 2, True), ("gray", 8, True),
             ("gray", 16, True), ("rgb", 8, True), ("rgb", 16, True), ("palette", 4, True),
             ("gray_alpha", 8, True), ("gray_alpha", 16, True), ("rgba", 16, True)]
PNG_COLOR = {"gray": (0, 1), "rgb": (2, 3), "palette": (3, 1), "gray_alpha": (4, 2),
             "rgba": (6, 4)}


@pytest.mark.parametrize("kind,depth,adam7", PNG_CASES,
                         ids=[f"{k}-{d}bit{'-adam7' if a else ''}" for k, d, a in PNG_CASES])
def test_png_equals_jax(tmp_path, kind, depth, adam7):
    rng = np.random.default_rng(depth * 10 + len(kind))
    path = str(tmp_path / "x.png")
    h, w = 13, 19
    if kind == "bilevel":                                     # PIL's mode 1
        Image.fromarray(_image(1, h, w, 1)[:, :, 0] > 128).save(path)
    elif kind == "palette" and not adam7:                     # PIL's palette writer
        img = Image.fromarray(rng.integers(0, 1 << depth, (h, w)).astype(np.uint8), "P")
        img.putpalette(list(rng.integers(0, 256, 3 << depth)))
        img.save(path, bits=depth)
    else:
        color, channels = PNG_COLOR[kind]
        samples = rng.integers(0, 1 << depth, (h, w, channels))
        palette = rng.integers(0, 256, (1 << depth, 3)) if kind == "palette" else None
        with open(path, "wb") as f:
            f.write(png_bytes(samples, color, depth, interlace=adam7, palette=palette))
    with open(path, "rb") as f:
        header = f.read(29)
    assert (header[24], header[28]) == (depth, int(adam7))
    _assert_port_equals_jax(path)
    _assert_library_equals_twin(path)


# ---- BMP -----------------------------------------------------------------------

BMP_CASES = ["gray8", "palette8", "rgb24", "rgbx32", "rgb24-top-down"]


@pytest.mark.parametrize("kind", BMP_CASES)
def test_bmp_equals_jax(tmp_path, kind):
    arr = _image(7, 11, 14, 4)
    path = str(tmp_path / "x.bmp")
    if kind == "gray8":
        Image.fromarray(arr[:, :, 0]).save(path)
    elif kind == "palette8":
        img = Image.fromarray(arr[:, :, 0], "P")
        img.putpalette(list(np.random.default_rng(3).integers(0, 256, 768)))
        img.save(path)
    elif kind == "rgbx32":
        Image.fromarray(arr).save(path)                       # RGBA -> 32-bit BI_RGB
    else:
        Image.fromarray(arr[:, :, :3]).save(path)
    if kind.endswith("top-down"):     # negative height, rows stored top first
        blob = bytearray(open(path, "rb").read())
        offset, height = struct.unpack("<I", blob[10:14])[0], struct.unpack("<i", blob[22:26])[0]
        stride = (len(blob) - offset) // height
        rows = [blob[offset + i * stride:offset + (i + 1) * stride] for i in range(height)]
        blob[22:26] = struct.pack("<i", -height)
        blob[offset:] = b"".join(rows[::-1])
        with open(path, "wb") as f:
            f.write(bytes(blob))
    _assert_port_equals_jax(path)
    _assert_library_equals_twin(path)


# ---- the committed fixtures --------------------------------------------------

FIXTURE_NAMES = sorted(n for n in MANIFEST if not n.startswith("save_gray"))
# the twin's Python VP8L decoder takes ~30 s per 640 x 376 frame; its small
# animated WebP cases are in tests/test_torch_imageio_anim.py
LIBRARY_ONLY = ("kitti_webp_anim/",)


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_matches_manifest_and_jax(name):
    path = os.path.join(FIXTURES, name)
    want = MANIFEST[name]
    gray, depth = tds.load_gray(path), tds.load_depth(path)
    assert list(gray.shape) == want["shape"]
    assert _sha(gray) == want["load_gray_sha256"]
    assert _sha(depth) == want["load_depth_sha256"]
    _assert_port_equals_jax(path)
    if name.startswith(LIBRARY_ONLY):
        return
    plain = images_plain.decode(path)
    assert _sha(images.gray_f32(plain)) == want["load_gray_sha256"]
    assert _sha(images.depth_f32(plain)) == want["load_depth_sha256"]


# ---- the folder readers --------------------------------------------------------

def _kitti_frames():
    return [(jds.load_gray(os.path.join(KITTI, f"image_left_{i}.png")),
             jds.load_gray(os.path.join(KITTI, f"image_right_{i}.png"))) for i in range(3)]


@pytest.mark.parametrize("quality,restart", [(75, False), (95, True)])
def test_malaga_jpeg_equals_jax(tmp_path, quality, restart):
    img = tmp_path / "Images"
    os.makedirs(img)
    kw = {"quality": quality, **({"restart_marker_rows": 1} if restart else {})}
    for i, (left, right) in enumerate(_kitti_frames()):
        stamp = f"img_CAMERA1_{1261228749.918590 + 0.05 * i:.6f}"
        Image.fromarray(left.astype(np.uint8)).save(img / f"{stamp}_left.jpg", **kw)
        if i != 1:                     # a left image without its right: skipped
            Image.fromarray(right.astype(np.uint8)).save(img / f"{stamp}_right.jpg", **kw)
    for count in (None, 1):
        got_t = list(tds.iter_malaga_stereo(str(tmp_path), count=count))
        got_j = list(jds.iter_malaga_stereo(str(tmp_path), count=count))
        assert len(got_t) == len(got_j) == (2 if count is None else 1)
        for a, b in zip(got_t, got_j):
            assert a.timestamp == b.timestamp
            np.testing.assert_array_equal(a.left, b.left)
            np.testing.assert_array_equal(a.right, b.right)


def test_kitti_folder_of_mixed_formats_equals_jax(tmp_path):
    """PNG frames take the native prefetcher, JPEG and BMP frames the second
    library, in one sequence."""
    for sub in ("image_0", "image_1"):
        os.makedirs(tmp_path / sub)
    for i, (left, right) in enumerate(_kitti_frames()):
        ext = ("png", "jpg", "bmp")[i]
        for sub, arr in (("image_0", left), ("image_1", right)):
            Image.fromarray(arr.astype(np.uint8)).save(tmp_path / sub / f"{i:06d}.{ext}")
    got_t = list(tds.iter_kitti_odometry(str(tmp_path)))
    got_j = list(jds.iter_kitti_odometry(str(tmp_path)))
    assert len(got_t) == len(got_j) == 3
    for a, b in zip(got_t, got_j):
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)


def test_boss_jpeg_log_equals_jax(tmp_path):
    """A BOSS log with JPEG payloads: each package's writer writes the same
    files (the port's save_gray is PIL's), and both read them alike."""
    frames = [jds.StereoFrame(timestamp=100.0 + 0.1 * i, left=left, right=right,
                              gt_pose=np.eye(4, dtype=np.float32))
              for i, (left, right) in enumerate(_kitti_frames())]
    cam = jds.kitti_camera(*frames[0].left.shape)
    logs = {}
    for name, boss in (("port", tboss), ("jax", jboss)):
        logs[name] = str(tmp_path / name / "messages.json")
        os.makedirs(os.path.dirname(logs[name]))
        assert boss.write_boss_stereo(logs[name], frames, cam, image_format="jpg") == 3
    payloads = {name: sorted(p for p in (tmp_path / name).rglob("*.jpg")) for name in logs}
    assert len(payloads["port"]) == len(payloads["jax"]) == 6
    for a, b in zip(payloads["port"], payloads["jax"]):
        assert a.name == b.name and a.read_bytes() == b.read_bytes()
    got_t = list(tboss.iter_boss_stereo(logs["port"]))
    got_j = list(jboss.iter_boss_stereo(logs["port"]))
    assert len(got_t) == len(got_j) == 3
    for a, b in zip(got_t, got_j):
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)


# ---- save_gray -------------------------------------------------------------------

SAVE_CASES = [(".jpg", (37, 53)), (".jpeg", (8, 8)), (".JPG", (1, 1)), (".jpg", "kitti"),
              (".bmp", (37, 53)), (".bmp", (5, 3)), (".tiff", (4, 4)), (".gif", (4, 4)),
              (".tif", "kitti"), (".gif", "kitti"), (".gif", (37, 53)), (".pfm", (5, 3))]
SAVE_IDS = [f"{e[1:]}-{s if isinstance(s, str) else '%dx%d' % s}" for e, s in SAVE_CASES]


@pytest.mark.parametrize("ext,size", SAVE_CASES, ids=SAVE_IDS)
def test_save_gray_writes_what_pil_writes(tmp_path, ext, size):
    if size == "kitti":
        img = jds.load_gray(os.path.join(KITTI, "image_left_0.png"))
    else:
        img = np.random.default_rng(size[0]).uniform(-20, 280, size).astype(np.float32)
    port, pil = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    tds.save_gray(port, img)
    jds.save_gray(pil, img)
    with open(port, "rb") as a, open(pil, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(jds.load_gray(port), jds.load_gray(pil))
    np.testing.assert_array_equal(tds.load_gray(port), jds.load_gray(pil))


def test_save_gray_matches_the_manifest(tmp_path):
    want = MANIFEST["save_gray"]
    path = str(tmp_path / f"k{want['extension']}")
    tds.save_gray(path, tds.load_gray(os.path.join(REPO, want["source"])))
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == want["pil_file_sha256"]
    assert _sha(tds.load_gray(path)) == want["load_gray_sha256"]


@pytest.mark.parametrize("name", ["x.webp", "x.jp2", "x", "x.jpg.txt"])
def test_save_gray_refuses_other_extensions(tmp_path, name):
    path = tmp_path / name
    with pytest.raises(ValueError, match="save_gray"):
        tds.save_gray(str(path), np.zeros((4, 4), np.float32))
    assert not path.exists()


# ---- refusals ----------------------------------------------------------------------

def _jpeg(mode="L", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_image(5, 24, 32, 3)).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _sof_patched(blob: bytes, marker=None, offset=None, value=None) -> bytes:
    at = blob.index(b"\xff\xc0")
    out = bytearray(blob)
    if marker is not None:
        out[at + 1] = marker
    if offset is not None:
        out[at + 4 + offset] = value
    return bytes(out)


def _first_scans(blob: bytes, n: int) -> bytes:
    """A progressive file cut after its first ``n`` scans."""
    starts = [i for i in range(len(blob) - 1) if blob[i] == 0xFF and blob[i + 1] == 0xDA]
    return blob[:starts[n]] + b"\xff\xd9"


UNSUPPORTED = {
    "12-bit": (lambda: _sof_patched(_jpeg(), offset=0, value=12), "precision"),
    "hierarchical": (lambda: _sof_patched(_jpeg(), marker=0xC5), "hierarchical"),
    "two-components": (lambda: _sof_patched(_jpeg("RGB"), offset=5, value=2), "components"),
    "arithmetic-lossless": (lambda: jpeg_lossless_bytes(_image(22, 9, 13, 1), 1, 0).replace(
        b"\xff\xc3", b"\xff\xcb", 1), "arithmetic-coded lossless"),
}


@pytest.mark.parametrize("variant", sorted(UNSUPPORTED))
def test_unsupported_jpeg_raises_naming_the_file(tmp_path, variant):
    make, reason = UNSUPPORTED[variant]
    path = str(tmp_path / f"{variant}.jpg")
    with open(path, "wb") as f:
        f.write(make())
    for read in (tds.load_gray, tds.load_depth, images_plain.decode):
        with pytest.raises(ValueError, match=reason) as err:
            read(path)
        assert path in str(err.value)


# Refused before this slice, read now: PIL's CMYK JPEG (Adobe, inverted), YCCK
# (tests/torch_imagefiles.py::jpeg_color_bytes with an Adobe transform 2),
# lossless SOF3 (::jpeg_lossless_bytes) in gray, RGB and CMYK, and
# arithmetic coding, sequential and progressive (::jpeg_arith_bytes, with
# restart markers and a DAC segment).
FORMERLY_REFUSED = {
    "cmyk": lambda: _jpeg("CMYK"),
    "cmyk-progressive": lambda: _jpeg("CMYK", progressive=True, quality=90),
    "ycck-420": lambda: jpeg_color_bytes(None, ((2, 2), (1, 1), (1, 1), (2, 2)), 80,
                                         planes=_image(9, 23, 41, 4), adobe=2),
    "cmyk-no-adobe-marker": lambda: jpeg_color_bytes(None, ((1, 1),) * 4, 80,
                                                     planes=_image(10, 23, 41, 4), adobe=None),
    "lossless": lambda: jpeg_lossless_bytes(_image(11, 17, 23, 1), 1, 0),
    "lossless-predictor7-pt2": lambda: jpeg_lossless_bytes(_image(12, 17, 23, 1), 7, 2),
    "lossless-rgb-predictor4": lambda: jpeg_lossless_bytes(_image(13, 17, 23, 3), 4, 0,
                                                           adobe=0),
    "lossless-rgb-scan-per-component": lambda: jpeg_lossless_bytes(
        _image(14, 17, 23, 3), 6, 1, interleave=False, adobe=0),
    "lossless-cmyk-predictor5": lambda: jpeg_lossless_bytes(_image(15, 17, 23, 4), 5, 0),
    "arithmetic": lambda: jpeg_arith_bytes(_image(18, 17, 23, 1), ((1, 1),), 75),
    "arithmetic-420-restart": lambda: jpeg_arith_bytes(
        _image(19, 37, 53, 3), ((2, 2), (1, 1), (1, 1)), 90, restart_mcus=3),
    "arithmetic-conditioning": lambda: jpeg_arith_bytes(
        _image(20, 17, 23, 3), ((1, 1),) * 3, 95, dac={(0, 0): 0x52, (1, 0): 12}),
    "arithmetic-progressive-422": lambda: jpeg_arith_bytes(
        _image(21, 21, 40, 3), ((2, 1), (1, 1), (1, 1)), 70, progressive=True,
        restart_mcus=2),
    # libjpeg block-smooths a progressive file whose first AC coefficients
    # are incomplete (more cases in tests/test_torch_imageio_formats.py)
    "incomplete-progressive": lambda: _first_scans(_jpeg("RGB", progressive=True), 2),
}


@pytest.mark.parametrize("variant", sorted(FORMERLY_REFUSED))
def test_formerly_refused_jpeg_reads_as_jax(tmp_path, variant):
    path = str(tmp_path / f"{variant}.jpg")
    with open(path, "wb") as f:
        f.write(FORMERLY_REFUSED[variant]())
    _assert_port_equals_jax(path)
    _assert_library_equals_twin(path)
    assert images.decode(path).mode == Image.open(path).mode


LOSSLESS_REFUSED = {
    "ycbcr": (lambda: jpeg_lossless_bytes(_image(16, 9, 13, 3), 1, 0), "lossless YCbCr"),
    "ycck": (lambda: jpeg_lossless_bytes(_image(17, 9, 13, 4), 1, 0, adobe=2), "lossless YCCK"),
}


@pytest.mark.parametrize("variant", sorted(LOSSLESS_REFUSED))
def test_lossless_jpeg_pil_cannot_convert_raises(tmp_path, variant):
    """libjpeg-turbo converts no colours in a lossless file, so PIL raises on
    these; so does the port, naming the file."""
    make, reason = LOSSLESS_REFUSED[variant]
    path = str(tmp_path / f"{variant}.jpg")
    with open(path, "wb") as f:
        f.write(make())
    with pytest.raises(OSError):
        Image.open(path).load()
    for read in (tds.load_gray, tds.load_depth, images_plain.decode):
        with pytest.raises(ValueError, match=reason) as err:
            read(path)
        assert path in str(err.value)


def test_a_file_no_decoder_reads_raises(tmp_path):
    """Bytes no plugin of PIL's claims (its TGA reader, which has no magic
    number, declines a second byte other than 0 or 1)."""
    path = tmp_path / "x.img"
    path.write_bytes(b"\x13\x37 not an image" + bytes(32))
    with pytest.raises(OSError):
        Image.open(str(path))
    for read in (tds.load_gray, tds.load_depth, images_plain.decode):
        with pytest.raises(ValueError, match=re.escape(images.UNKNOWN)):
            read(str(path))
    with pytest.raises(ValueError, match=re.escape(images.UNKNOWN)):
        list(tds._decoded([str(path)]))          # the folder readers' path


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "image_extra.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(images, "SOURCES", [broken])
    monkeypatch.setattr(images, "_lib", None)
    with pytest.raises(RuntimeError, match="building libproslam_image_extra failed"):
        images.decode(os.path.join(FIXTURES, "kitti_left_0.jpg"))


CHILD = r"""
import hashlib, json, sys
for name in ("jax", "jaxlib", "srrg2_proslam_tpu", "PIL"):
    sys.modules[name] = None
from srrg2_proslam_tpu_torch.io import datasets
manifest = json.load(open("test_data/torch_io/MANIFEST.json"))
for name in ("kitti_left_1.jpg", "icl_palette.png"):
    gray = datasets.load_gray("test_data/torch_io/" + name)
    assert hashlib.sha256(gray.tobytes()).hexdigest() == manifest[name]["load_gray_sha256"]
print("decoded without jax and PIL")
"""


def test_port_reads_jpeg_without_jax_or_pil():
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "decoded without jax and PIL"
