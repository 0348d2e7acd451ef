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
16-bit Deflate, frame 1's as float32 tiles with the float predictor);
``kitti_tga/`` in the KITTI odometry layout (the same cut pairs as
run-length-encoded TGA, written by PIL); and one small file per family the
port's later decoders read (written by PIL where it writes the variant,
else by ``tests/torch_imagefiles.py``): CCITT Group 4 and Group 3 2-D
bilevel TIFF, JPEG-compressed YCbCr 4:2:0 TIFF in two strips behind
JPEGTables, YCbCr 4:2:2 LZW TIFF with ReferenceBlackWhite, an
orientation-6 TIFF, a BigTIFF with fill order 2, a progressive JPEG cut
after three scans (block-smoothed on decoding) and an RLE RGB TGA; and,
written by PIL from the same crops, a DXT1 DDS, an SGI, an RGB PCX, a PNG
ICO, a QOI, an IM, a lossless and a lossy (RGBA) WebP and the bilevel crop
as XBM and MSP; two more folders: ``tum_jp2/`` in the TUM RGB-D layout
(ICL frames 0 and 1 at 640 x 480: the RGB as an irreversible 9/7 JP2 with
the ICT and quality layers 40 / 20 / 10 by rate, the depth as a reversible
5/3 16-bit J2K codestream in two rows of 640 x 256 tiles, RPCL, 128 x 128
precincts: one tile column, because PIL's writer misplaces the samples of an
I;16 image's tiles right of the first column)
and ``kitti_zstd/`` in the KITTI odometry layout (the cut pairs 0 and 1,
pair 0 as 8-bit Zstandard TIFF with predictor 2, pair 1 as 16-bit samples
256 x the gray), written by PIL; and small JPEG 2000 and Zstandard files
from the 128 x 96 crop: an RGB JP2 (9/7, ICT, three layers by dB), a 16-bit
depth J2K (5/3, three rows of 128 x 32 tiles, PCRL, precincts), a Zstandard RGB TIFF
written by PIL and a gray one in tiles with the content checksum (written
by ``tests/torch_imagefiles.py``).
``MANIFEST.json`` holds, for each file, the SHA-256 of
the float32 bytes of the JAX package's ``load_gray`` and ``load_depth``
and their shape; and for ``save_gray`` of KITTI left 0 to ``.jpg``, the
SHA-256 of PIL's file and of the JAX package's ``load_gray`` of it, and
the same for ``save_gray`` to ``.tif``, ``.gif``, ``.tga``, ``.sgi``,
``.pcx``, ``.dds`` and ``.im``.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from srrg2_proslam_tpu.io import datasets as jds  # noqa: E402
from torch_imagefiles import (bc6h_blocks, dds_dx10_bytes, lzw_tiff,  # noqa: E402
                              png_bytes, split_jpeg_tables, tiff_bytes, tiff_chunks_bytes,
                              ycbcr_units, zstd_frame)

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


def tga_folder():
    """kitti_tga/: the cut KITTI pairs 0 and 1 as run-length-encoded TGA."""
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(OUT, "kitti_tga", sub), exist_ok=True)
    for i in (0, 1):
        for sub, side in (("image_0", "left"), ("image_1", "right")):
            gray = np.asarray(Image.open(os.path.join(KITTI, f"image_{side}_{i}.png")))
            Image.fromarray(np.ascontiguousarray(gray[:, KITTI_COLS])).save(
                os.path.join(OUT, "kitti_tga", sub, f"{i:06d}.tga"), compression="tga_rle")
    with open(os.path.join(OUT, "kitti_tga", "times.txt"), "w") as f:
        f.write("0.000000e+00\n1.036300e-01\n")


def later_families(rgb: Image.Image, kitti: Image.Image):
    """One small file per family of the TIFF, JPEG and TGA decoders added
    after the TIFF folders (see the module docstring)."""
    bilevel = kitti.crop((400, 100, 640, 260)).convert("1")
    bilevel.save(os.path.join(OUT, "kitti_ccitt_g4.tif"), compression="group4")
    bilevel.save(os.path.join(OUT, "kitti_ccitt_g3_2d.tif"), compression="group3",
                 tiffinfo={292: 1})
    crop = rgb.crop((240, 200, 368, 296))                    # 128 x 96
    strips, tables = [], b""
    for y in (0, 48):
        buf = io.BytesIO()
        crop.crop((0, y, 128, y + 48)).save(buf, "JPEG", quality=85, subsampling=2)
        tables, rest = split_jpeg_tables(buf.getvalue())
        strips.append(rest)
    with open(os.path.join(OUT, "icl_jpeg_ycbcr_420.tif"), "wb") as f:
        f.write(tiff_chunks_bytes(128, 96, strips, [
            (258, 3, [8, 8, 8]), (259, 3, [7]), (262, 3, [6]), (277, 3, [3]), (284, 3, [1]),
            (347, 7, list(tables)), (530, 3, [2, 2])], rows_per_strip=48))
    ycc = np.asarray(crop.convert("YCbCr")).astype(np.int64)
    cb = ycc[:, 0::2, 1]
    cr = ycc[:, 0::2, 2]
    with open(os.path.join(OUT, "icl_ycbcr_422_lzw.tif"), "wb") as f:
        f.write(tiff_chunks_bytes(128, 96, [lzw_tiff(ycbcr_units(ycc[:, :, 0], cb, cr, 2, 1))], [
            (258, 3, [8, 8, 8]), (259, 3, [5]), (262, 3, [6]), (277, 3, [3]),
            (530, 3, [2, 1]), (532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                                        (240, 1)])]))
    gray = crop.convert("L")
    gray.save(os.path.join(OUT, "icl_orientation_6.tif"), compression="tiff_lzw",
              tiffinfo={274: 6})
    reverse = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    g = np.asarray(gray)
    with open(os.path.join(OUT, "icl_bigtiff_fill2.tif"), "wb") as f:
        f.write(tiff_chunks_bytes(128, 96, [g[y:y + 32].tobytes().translate(reverse)
                                            for y in range(0, 96, 32)],
                                  [(258, 3, [8]), (259, 3, [1]), (262, 3, [1]), (266, 3, [2])],
                                  rows_per_strip=32, bigtiff=True))
    buf = io.BytesIO()
    rgb.crop((200, 160, 360, 280)).save(buf, "JPEG", quality=90, progressive=True,
                                         subsampling=2)
    blob = buf.getvalue()
    scans = [i for i in range(len(blob) - 1) if blob[i:i + 2] == b"\xff\xda"]
    with open(os.path.join(OUT, "icl_progressive_3_scans.jpg"), "wb") as f:
        f.write(blob[:scans[3]] + b"\xff\xd9")
    crop.save(os.path.join(OUT, "icl_rgb_rle.tga"), compression="tga_rle")


def raster_families(rgb: Image.Image, kitti: Image.Image):
    """One small file per reader of PIL's other raster formats (see the
    module docstring), written by PIL."""
    crop = rgb.crop((240, 200, 368, 296))                    # 128 x 96
    crop.convert("RGBA").save(os.path.join(OUT, "icl_dxt1.dds"), pixel_format="DXT1")
    small = crop.resize((64, 48), Image.Resampling.NEAREST)
    small.convert("L").save(os.path.join(OUT, "icl_gray.sgi"))
    small.save(os.path.join(OUT, "icl_rgb.pcx"))
    small.crop((0, 0, 48, 48)).save(os.path.join(OUT, "icl_rgb.ico"), sizes=[(48, 48)])
    small.save(os.path.join(OUT, "icl_rgb.qoi"))
    small.convert("L").save(os.path.join(OUT, "icl_gray.im"))
    small.save(os.path.join(OUT, "icl_rgb_lossless.webp"), lossless=True)
    small.convert("RGBA").save(os.path.join(OUT, "icl_rgba_lossy.webp"), quality=80)
    bilevel = kitti.crop((400, 100, 640, 260)).convert("1")
    bilevel.save(os.path.join(OUT, "kitti_bilevel.xbm"))
    bilevel.save(os.path.join(OUT, "kitti_bilevel.msp"))


def jp2_zstd_folders():
    """tum_jp2/ and kitti_zstd/ (see the module docstring)."""
    tum = os.path.join(OUT, "tum_jp2")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(tum, sub), exist_ok=True)
    for i in (0, 1):
        rgb = Image.open(os.path.join(ROOT, "test_data", "icl", f"image_rgb_{i}.png"))
        rgb.convert("RGB").save(os.path.join(tum, "rgb", f"{i}.jp2"), irreversible=True, mct=1,
                                quality_mode="rates", quality_layers=[40, 20, 10])
        depth = jds.load_depth(os.path.join(ROOT, "test_data", "icl", f"image_depth_{i}.pgm"))
        Image.fromarray(depth.astype(np.uint16)).save(
            os.path.join(tum, "depth", f"{i}.j2k"), tile_size=(640, 256), progression="RPCL",
            precinct_size=(128, 128))
    with open(os.path.join(tum, "rgb.txt"), "w") as f:
        f.write("# timestamp filename\n0.000000 rgb/0.jp2\n0.033333 rgb/1.jp2\n")
    with open(os.path.join(tum, "depth.txt"), "w") as f:
        f.write("# timestamp filename\n0.000000 depth/0.j2k\n0.033333 depth/1.j2k\n")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(OUT, "kitti_zstd", sub), exist_ok=True)
    for i in (0, 1):
        for sub, side in (("image_0", "left"), ("image_1", "right")):
            gray = np.asarray(Image.open(os.path.join(KITTI, f"image_{side}_{i}.png")))
            gray = np.ascontiguousarray(gray[:, KITTI_COLS])
            if i == 1:
                gray = gray.astype(np.uint16) * 256
            Image.fromarray(gray).save(os.path.join(OUT, "kitti_zstd", sub, f"{i:06d}.tif"),
                                       compression="zstd", tiffinfo={317: 2})
    with open(os.path.join(OUT, "kitti_zstd", "times.txt"), "w") as f:
        f.write("0.000000e+00\n1.036300e-01\n")


def jp2_zstd_families(rgb: Image.Image):
    """The small JPEG 2000 and Zstandard files (see the module docstring)."""
    crop = rgb.crop((240, 200, 368, 296))                    # 128 x 96
    crop.save(os.path.join(OUT, "icl_rgb_97_layers.jp2"), irreversible=True, mct=1,
              quality_mode="dB", quality_layers=[30, 40, 50])
    depth = jds.load_depth(os.path.join(ROOT, "test_data", "icl", "image_depth_0.pgm"))
    Image.fromarray(depth[200:296, 240:368].astype(np.uint16)).save(
        os.path.join(OUT, "icl_depth16_tiles.j2k"), tile_size=(128, 32), progression="PCRL",
        precinct_size=(16, 16), codeblock_size=(8, 8), num_resolutions=3)
    crop.save(os.path.join(OUT, "icl_rgb_zstd.tif"), compression="zstd")
    gray = np.asarray(crop.convert("L")).astype(np.int64)[:, :, None]
    with open(os.path.join(OUT, "icl_gray_zstd_tiles.tif"), "wb") as f:
        f.write(tiff_bytes(gray, 8, 1, compression=50000, predictor=2, tile=(48, 32),
                           codec=zstd_frame(level=19, checksum=True)))


def webp_anim_bc6h():
    """kitti_webp_anim/ and the two BC6H files (see the module docstring)."""
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(OUT, "kitti_webp_anim", sub), exist_ok=True)
    for i in (0, 1):
        for sub, side in (("image_0", "left"), ("image_1", "right")):
            gray = np.asarray(Image.open(os.path.join(KITTI, f"image_{side}_{i}.png")))
            cut = np.ascontiguousarray(gray[:, KITTI_COLS])
            later = cut.copy()
            later[100:164, 200:264] = 255 - later[100:164, 200:264]
            Image.fromarray(cut).convert("RGB").save(
                os.path.join(OUT, "kitti_webp_anim", sub, f"{i:06d}.webp"), save_all=True,
                append_images=[Image.fromarray(later).convert("RGB")], lossless=True)
    with open(os.path.join(OUT, "kitti_webp_anim", "times.txt"), "w") as f:
        f.write("0.000000e+00\n1.036300e-01\n")
    for dxgi, name in ((95, "bc6h_unsigned.dds"), (96, "bc6h_signed.dds")):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(dds_dx10_bytes(30, 22, dxgi, bc6h_blocks(8 * 6, dxgi)))


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
    """PIL's save_gray file of ``source`` as a manifest entry: the file is
    named ``save_gray<extension>`` (SGI and IM keep the name in the file),
    as ``chip_smoke.py`` names its own."""
    with tempfile.TemporaryDirectory() as tmp:
        saved = os.path.join(tmp, "save_gray" + extension)
        Image.fromarray(np.clip(source, 0, 255).astype(np.uint8), mode="L").save(saved)
        with open(saved, "rb") as f:
            blob = f.read()
        return {"source": SAVE_SOURCE, "extension": extension,
                "pil_file_sha256": hashlib.sha256(blob).hexdigest(),
                "load_gray_sha256": sha(jds.load_gray(saved))}


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
    tga_folder()
    later_families(rgb, kitti)
    raster_families(rgb, kitti)
    jp2_zstd_folders()
    jp2_zstd_families(rgb)
    webp_anim_bc6h()

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
    for ext in (".tga", ".sgi", ".pcx", ".dds", ".im"):
        manifest["save_gray_" + ext[1:]] = save_entry(source, ext)
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(root, n)) for root, _, names in os.walk(OUT)
                for n in names)
    count = sum(not k.startswith("save_gray") for k in manifest)
    print(f"{count} fixtures and MANIFEST.json in {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
