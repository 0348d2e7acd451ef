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
and a 24-bit BMP.  ``MANIFEST.json`` holds, for each file, the SHA-256 of
the float32 bytes of the JAX package's ``load_gray`` and ``load_depth``
and their shape; and for ``save_gray`` of KITTI left 0 to ``.jpg``, the
SHA-256 of PIL's file and of the JAX package's ``load_gray`` of it.
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
from torch_imagefiles import png_bytes  # noqa: E402

OUT = os.path.join(ROOT, "test_data", "torch_io")
KITTI = os.path.join(ROOT, "test_data", "kitti", "city")
ICL_RGB = os.path.join(ROOT, "test_data", "icl", "image_rgb_0.png")
SAVE_SOURCE = "test_data/kitti/city/image_left_0.png"


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

    manifest = {}
    for name in sorted(os.listdir(OUT)):
        if name == "MANIFEST.json":
            continue
        path = os.path.join(OUT, name)
        gray, depth = jds.load_gray(path), jds.load_depth(path)
        manifest[name] = {"shape": list(gray.shape), "load_gray_sha256": sha(gray),
                          "load_depth_sha256": sha(depth)}
    source = jds.load_gray(os.path.join(ROOT, SAVE_SOURCE))
    buf = io.BytesIO()
    Image.fromarray(np.clip(source, 0, 255).astype(np.uint8), mode="L").save(buf, "JPEG")
    saved = os.path.join(OUT, "_save_gray.jpg")
    with open(saved, "wb") as f:
        f.write(buf.getvalue())
    manifest["save_gray"] = {"source": SAVE_SOURCE, "extension": ".jpg",
                             "pil_file_sha256": hashlib.sha256(buf.getvalue()).hexdigest(),
                             "load_gray_sha256": sha(jds.load_gray(saved))}
    os.remove(saved)
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(manifest) - 1} fixtures and MANIFEST.json in {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
