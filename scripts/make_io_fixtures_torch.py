"""Write the image fixtures of ``test_data/torch_io/`` and their manifest.

Needs PIL and the JAX package (their decoders are the reference), so it
runs where the CPU tests run:

    JAX_PLATFORMS=cpu python3 scripts/make_io_fixtures_torch.py

The files are the ones the port's second image library (``io/images.py``)
reads where the JAX package takes its PIL branch: the KITTI city pairs 0
and 1 as gray baseline JPEG at quality 95 (pair 1 with a restart marker
every MCU row), ICL ``image_rgb_0.png`` as progressive 4:2:0 JPEG at
quality 90, a palette PNG, a 1-bit PNG, an Adam7-interlaced RGB PNG
(written by ``tests/torch_imagefiles.py``; PIL writes no interlaced PNG)
and a 24-bit BMP; and two folders of TIFF frames (written by PIL, LZW or
Deflate with horizontal differencing, tiles and the float predictor by
``tests/torch_imagefiles.py``): ``kitti_tiff/`` in the KITTI odometry
layout (the city pairs 0 and 1 cut to their middle 640 columns, pair 0 as
8-bit LZW with predictor 2, pair 1 as 16-bit samples 256 x the gray) and
``tum_tiff/`` in the TUM RGB-D layout (ICL frames 0 and 1 at their full
640 x 480: the gray intensity as 8-bit LZW, frame 0's depth as
16-bit Deflate, frame 1's as float32 tiles with the float predictor).
``MANIFEST.json`` holds, for each file, the SHA-256 of
the float32 bytes of the JAX package's ``load_gray`` and ``load_depth``
and their shape; and for ``save_gray`` of KITTI left 0 to ``.jpg``, the
SHA-256 of PIL's file and of the JAX package's ``load_gray`` of it, and
the same for ``save_gray`` to ``.tif`` and ``.gif``.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from srrg2_proslam_tpu.io import datasets as jds  # noqa: E402
from torch_imagefiles import png_bytes, tiff_bytes  # noqa: E402

OUT = os.path.join(ROOT, "test_data", "torch_io")
KITTI = os.path.join(ROOT, "test_data", "kitti", "city")
ICL_RGB = os.path.join(ROOT, "test_data", "icl", "image_rgb_0.png")
SAVE_SOURCE = "test_data/kitti/city/image_left_0.png"
KITTI_COLS = slice(300, 940)          # the middle 640 of 1241 columns


def tiff_folders():
    """kitti_tiff/ and tum_tiff/ (see the module docstring)."""
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(OUT, "kitti_tiff", sub), exist_ok=True)
    for i in (0, 1):
        for sub, side in (("image_0", "left"), ("image_1", "right")):
            gray = np.asarray(Image.open(os.path.join(KITTI, f"image_{side}_{i}.png")))
            gray = np.ascontiguousarray(gray[:, KITTI_COLS])
            path = os.path.join(OUT, "kitti_tiff", sub, f"{i:06d}.tif")
            if i == 0:
                Image.fromarray(gray).save(path, compression="tiff_lzw", tiffinfo={317: 2})
            else:
                Image.fromarray(gray.astype(np.uint16) * 256).save(
                    path, compression="tiff_lzw", tiffinfo={317: 2})
    with open(os.path.join(OUT, "kitti_tiff", "times.txt"), "w") as f:
        f.write("0.000000e+00\n1.036300e-01\n")
    tum = os.path.join(OUT, "tum_tiff")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(tum, sub), exist_ok=True)
    for i in (0, 1):
        rgb = Image.open(os.path.join(ROOT, "test_data", "icl", f"image_rgb_{i}.png"))
        Image.fromarray(np.asarray(rgb.convert("L"))).save(
            os.path.join(tum, "rgb", f"{i}.tif"), compression="tiff_lzw", tiffinfo={317: 2})
        depth = jds.load_depth(os.path.join(ROOT, "test_data", "icl", f"image_depth_{i}.pgm"))
        path = os.path.join(tum, "depth", f"{i}.tif")
        if i == 0:
            Image.fromarray(depth.astype(np.uint16)).save(
                path, compression="tiff_adobe_deflate", tiffinfo={317: 2})
        else:
            with open(path, "wb") as f:
                f.write(tiff_bytes(depth[:, :, None], 32, 1, sample_format=3, compression=8,
                                   predictor=3, tile=(64, 64)))
    with open(os.path.join(tum, "rgb.txt"), "w") as f:
        f.write("# timestamp filename\n0.000000 rgb/0.tif\n0.033333 rgb/1.tif\n")
    with open(os.path.join(tum, "depth.txt"), "w") as f:
        f.write("# timestamp filename\n0.000000 depth/0.tif\n0.033333 depth/1.tif\n")


def fixture_files():
    """Every image file under OUT, as paths relative to it."""
    out = []
    for root, _, names in os.walk(OUT):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), OUT)
            if not name.endswith((".json", ".txt")) and not name.startswith("_"):
                out.append(rel)
    return sorted(out)


def save_entry(source: np.ndarray, extension: str) -> dict:
    """PIL's save_gray file of ``source`` as a manifest entry."""
    buf = io.BytesIO()
    Image.fromarray(np.clip(source, 0, 255).astype(np.uint8), mode="L").save(
        buf, Image.registered_extensions()[extension])
    saved = os.path.join(OUT, "_save_gray" + extension)
    with open(saved, "wb") as f:
        f.write(buf.getvalue())
    entry = {"source": SAVE_SOURCE, "extension": extension,
             "pil_file_sha256": hashlib.sha256(buf.getvalue()).hexdigest(),
             "load_gray_sha256": sha(jds.load_gray(saved))}
    os.remove(saved)
    return entry


def sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.float32).tobytes()).hexdigest()


def main():
    os.makedirs(OUT, exist_ok=True)
    for i in (0, 1):
        extra = {"restart_marker_rows": 1} if i == 1 else {}
        for side in ("left", "right"):
            gray = Image.open(os.path.join(KITTI, f"image_{side}_{i}.png"))
            gray.save(os.path.join(OUT, f"kitti_{side}_{i}.jpg"), quality=95, **extra)
    rgb = Image.open(ICL_RGB).convert("RGB")
    rgb.save(os.path.join(OUT, "icl_rgb_0_progressive_420.jpg"), quality=90,
             progressive=True, subsampling=2)
    crop = rgb.crop((200, 160, 360, 280))                  # 160 x 120
    crop.quantize(colors=64).save(os.path.join(OUT, "icl_palette.png"))
    kitti = Image.open(os.path.join(KITTI, "image_left_0.png"))
    kitti.crop((400, 100, 640, 260)).convert("1").save(os.path.join(OUT, "kitti_bilevel.png"))
    small = np.asarray(rgb.crop((240, 200, 368, 296)))     # 128 x 96
    with open(os.path.join(OUT, "icl_adam7_rgb.png"), "wb") as f:
        f.write(png_bytes(small, 2, 8, interlace=True))
    rgb.crop((40, 300, 168, 396)).save(os.path.join(OUT, "icl_rgb24.bmp"))
    tiff_folders()

    manifest = {}
    for name in fixture_files():
        path = os.path.join(OUT, name)
        gray, depth = jds.load_gray(path), jds.load_depth(path)
        manifest[name] = {"shape": list(gray.shape), "load_gray_sha256": sha(gray),
                          "load_depth_sha256": sha(depth)}
    source = jds.load_gray(os.path.join(ROOT, SAVE_SOURCE))
    manifest["save_gray"] = save_entry(source, ".jpg")
    manifest["save_gray_tif"] = save_entry(source, ".tif")
    manifest["save_gray_gif"] = save_entry(source, ".gif")
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(root, n)) for root, _, names in os.walk(OUT)
                for n in names)
    print(f"{len(manifest) - 3} fixtures and MANIFEST.json in {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
