"""Animated WebP and BC6H DDS through the port's readers, to the bit as the
JAX package reads them through PIL, on the CPU.

Animated WebP files are written by PIL (``save_all``), some then rewritten
chunk by chunk: PIL reads the first frame as libwebp's WebPAnimDecoder
composites it, the frame decoded into a transparent black canvas at its
offset.  PIL's writer crops a first frame to its opaque bounding box, so
an RGBA canvas opaque only in part gives an offset frame.  BC6H files hold
random blocks of every mode (the reserved ones too) at a size that is no
multiple of 4.  Bounds, every case: the library's samples and mode equal
its plain twin's and PIL's, and the port's ``load_gray`` and
``load_depth`` equal the JAX package's to the bit; files PIL refuses raise
a ``ValueError`` naming the file and the rule.
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

from srrg2_proslam_tpu.io import datasets as jds

from srrg2_proslam_tpu_torch.io import datasets as tds
from srrg2_proslam_tpu_torch.io import images, images_plain
from test_torch_imageio_tiff import assert_reads_as_jax
import torch_imagefiles as tf


def _reads_as_pil_and_jax(path: str, twin: bool = True):
    """The library (and its twin) as PIL and the JAX package read the file;
    ``twin=False`` leaves the twin out (its Python VP8L decoder takes tens
    of seconds for a 640 x 376 frame)."""
    lib = images.decode(path)
    if twin:
        assert_reads_as_jax(path)
    else:
        assert lib.mode == Image.open(path).mode
        for name in ("load_gray", "load_depth"):
            got, want = getattr(tds, name)(path), getattr(jds, name)(path)
            assert got.dtype == want.dtype == np.float32, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(lib.samples, np.asarray(Image.open(path)).reshape(
        lib.samples.shape))


def _anim(frames, **kw) -> bytes:
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], **kw)
    return buf.getvalue()


def _rgba(h, w, seed, alpha=None):
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 4)).astype(np.uint8)
    arr[:, :, 3] = 255 if alpha is None else alpha
    return arr


def _offset_frames():
    """A 52 x 40 RGBA canvas opaque only in rows 10-29, columns 8-43 (PIL
    writes it as a 36 x 20 frame at (8, 10)), then a full frame."""
    first = np.zeros((40, 52, 4), np.uint8)
    first[10:30, 8:44] = _rgba(20, 36, 1)
    return [Image.fromarray(first, "RGBA"), Image.fromarray(_rgba(40, 52, 2, 90), "RGBA")]


def _anmf(blob: bytes, index: int = 0, x=None, flags=None, body=None) -> bytes:
    """The file with its index-th ANMF's x offset, flags or frame chunks
    rewritten."""
    chunks = tf.webp_chunks(blob)
    at = [i for i, (name, _) in enumerate(chunks) if name == b"ANMF"][index]
    data = bytearray(chunks[at][1])
    if x is not None:
        data[0:3] = (x // 2).to_bytes(3, "little")
    if flags is not None:
        data[15] = flags
    if body is not None:
        data[16:] = body
    chunks[at][1] = bytes(data)
    return tf.webp_bytes(chunks)


def _lossy_alpha():
    alpha = np.random.default_rng(3).integers(1, 256, (24, 33)).astype(np.uint8)
    return _anim([Image.fromarray(_rgba(24, 33, 3, alpha), "RGBA"),
                  Image.fromarray(_rgba(24, 33, 4), "RGBA")], lossless=False, quality=60)


ANIMATED = {
    "lossless-offset-frame": lambda: _anim(_offset_frames(), lossless=True),
    "lossy-with-alph": _lossy_alpha,
    "lossy-rgb": lambda: _anim([Image.fromarray(_rgba(23, 37, s)[:, :, :3]) for s in (5, 6)],
                               lossless=False, quality=70),
    "one-pixel-canvas": lambda: _anim([Image.fromarray(_rgba(1, 1, s), "RGBA") for s in (7, 8)],
                                      lossless=True),
    "first-frame-set-to-blend": lambda: _anmf(_anim(_offset_frames(), lossless=True), flags=1),
    "three-frames-first-covers": lambda: _anim(
        [Image.fromarray(_rgba(21, 30, s, 20 * s)) for s in (9, 10, 11)], lossless=True),
}
FIRST_CHUNKS = {"lossless-offset-frame": [b"VP8L"], "lossy-with-alph": [b"ALPH", b"VP8 "],
                "lossy-rgb": [b"VP8 "]}


@pytest.mark.parametrize("kind", ANIMATED)
def test_animated_webp_first_frame_reads_as_jax(tmp_path, kind):
    blob = ANIMATED[kind]()
    chunks = tf.webp_chunks(blob)
    anmf = [data for name, data in chunks if name == b"ANMF"]
    assert chunks[0][0] == b"VP8X" and chunks[0][1][0] & 0x02 and len(anmf) >= 2
    if kind in FIRST_CHUNKS:   # the frame chunks the case is about
        inner = tf.webp_chunks(b"RIFF\0\0\0\0WEBP" + anmf[0][16:])
        assert [name for name, _ in inner] == FIRST_CHUNKS[kind]
    path = str(tmp_path / "a.webp")
    with open(path, "wb") as f:
        f.write(blob)
    _reads_as_pil_and_jax(path)
    if kind in ("lossless-offset-frame", "first-frame-set-to-blend"):
        assert anmf[0][:3] == (4).to_bytes(3, "little")      # x 8
        canvas = images.decode(path).samples
        assert not canvas[:10].any() and not canvas[:, :8].any() and canvas[10:30, 8:44, 3].all()


REFUSED = {   # (file, the port's reason); PIL refuses each too
    "frame-outside-canvas": (lambda: _anmf(_anim(_offset_frames(), lossless=True), x=18),
                             "a frame lies outside the canvas"),
    "anmf-without-image-chunk": (lambda: _anmf(_anim(_offset_frames(), lossless=True),
                                               body=b"ALPH\x04\0\0\0\0\0\0\0"),
                                 "an ANMF with no image chunk"),
    "no-anmf": (lambda: tf.webp_bytes(tf.webp_chunks(_anim(_offset_frames(), lossless=True))[:2]),
                "an animated WebP with no frame"),
}


@pytest.mark.parametrize("kind", REFUSED)
def test_animated_webp_pil_refuses_raises_naming_the_file(tmp_path, kind):
    make, reason = REFUSED[kind]
    path = str(tmp_path / "r.webp")
    with open(path, "wb") as f:
        f.write(make())
    with pytest.raises(OSError):
        Image.open(path).load()
    for read in (tds.load_gray, tds.load_depth, images.decode, images_plain.decode):
        with pytest.raises(ValueError, match=f"WebP: {reason}") as err:
            read(path)
        assert path in str(err.value)


@pytest.mark.parametrize("dxgi", [95, 96], ids=["BC6H-unsigned", "BC6H-signed"])
def test_dds_bc6h_reads_as_jax(tmp_path, dxgi):
    """Random blocks of every BC6H mode and the reserved ones, 21 x 15."""
    path = str(tmp_path / "h.dds")
    with open(path, "wb") as f:
        f.write(tf.dds_dx10_bytes(21, 15, dxgi, tf.bc6h_blocks(6 * 4, dxgi)))
    _reads_as_pil_and_jax(path)
    samples = images.decode(path).samples
    assert images.decode(path).mode == "RGB" and 0 < samples.mean() < 255


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = ["kitti_webp_anim/image_0/000000.webp", "bc6h_unsigned.dds", "bc6h_signed.dds"]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_read_as_jax(name):
    """The committed files (the KITTI WebP through the library only, as
    chip_smoke.py reads it)."""
    _reads_as_pil_and_jax(os.path.join(REPO, "test_data", "torch_io", name),
                          twin=not name.endswith(".webp"))


def test_kitti_webp_anim_folder_reads_as_jax_and_as_the_png_frames():
    """Each file's first frame is the cut KITTI image (its second frame
    differs), so the folder reads as the PNG frames' gray."""
    seq = os.path.join(REPO, "test_data", "torch_io", "kitti_webp_anim")
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
