"""The port's second image library: the files the native decoder refuses,
read as the JAX package reads them through PIL.

``csrc/image_*.cpp`` decode, bit for bit as PIL 12 (with libjpeg-turbo
3.1, libtiff 4.7, OpenJPEG 2.5 and libwebp) does, the files PIL
identifies as:
- JPEG: baseline, progressive (block-smoothed as libjpeg's jdcoefct.c
  does where the first AC coefficients are incomplete) and lossless (SOF3)
  Huffman, sequential and progressive arithmetic coding; gray, YCbCr at
  any integral sampling, RGB, CMYK and YCCK; restart intervals;
- PNG of every colour type, bit depth and interlace;
- BMP: 1/4/8-bit palette files raw or RLE, 16/24/32-bit raw or with PIL's
  bit-field layouts, OS/2 headers;
- TIFF and BigTIFF (little-endian): strips or tiles, planar configuration
  1 or 2, no compression, PackBits, LZW (old-style too), Deflate, CCITT
  RLE / Group 3 / Group 4, JPEG, LZMA, ZSTD (``image_zstd.cpp``, a
  Zstandard frame decoder); predictors 2 and 3; fill order 2;
  orientation 2-8; bilevel, 2/4/8/12/16-bit gray, signed 16/32-bit,
  float32, gray + alpha, RGB(A) at 8/16 bits, palette, CMYK, LAB, YCbCr
  (libtiff's conversion);
- JPEG 2000 codestreams and JP2 files (``image_j2k.cpp``: every
  progression order and POC, tiles, precincts, layers, SOP / EPH, PPM /
  PPT, the ROI max-shift, the 5/3 and 9/7 wavelets, RCT / ICT; PIL's L,
  I;16, LA, RGB, RGBA, P and CMYK, sYCC converted as PIL converts it);
- GIF (the first frame), PNM (P1-P6, Pf), TGA, SGI, PCX, DDS (uncompressed,
  BC1-BC5, BC7), PSD (the composite), ICO / CUR, QOI, IM, SPIDER, Sun
  raster, MSP, XBM, XPM and WebP (lossless, and lossy with its alpha);
in PIL's order of trying its plugins (``decode_any``; a file of a format
PIL reads and the port does not raises naming the format).  It writes
baseline gray JPEG (quality 75) and PIL's GIF for mode L byte for byte as
PIL does; ``encode_tiff_gray``, ``encode_bmp_gray``, ``encode_tga_gray``,
``encode_sgi_gray``, ``encode_pcx_gray``, ``encode_dds_gray`` and
``encode_im_gray`` give PIL's bytes in Python.  The library is compiled
with g++ at first use into the git-ignored ``srrg2_proslam_tpu_torch/build/``
as ``io/native.py`` compiles the repo's decoder; a failed build raises with
the compiler's output.  ``images_plain.decode`` is the plain Python twin it
is held to (``images_plain_more`` and ``images_plain_j2k`` beside it).

A decoded file keeps PIL's mode, and ``gray_f32`` / ``depth_f32`` apply the
JAX package's rule for files that take its PIL branch
(``srrg2_proslam_tpu/io/datasets.py`` ``load_gray`` / ``load_depth``): L,
I and I;16 as they are (16-bit and 32-bit integers / 256), every other
mode through PIL's ``convert("L")`` (integer luma for colour and palette
entries, 0/255 for mode 1, I;16B clipped at 255, F clipped and truncated,
CMYK through RGB, LAB refused as PIL refuses it); depth is the first
channel of the samples as PIL holds them (palette indices, 0/1, R of RGB,
C of CMYK, L of LAB, float values of F).
"""
from __future__ import annotations

import ctypes
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from . import native

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / name for name in ("image_extra.cpp", "image_tiff.cpp", "image_ccitt.cpp",
                                     "image_gif_pnm.cpp", "image_tga.cpp", "image_sgi_pcx.cpp",
                                     "image_dds.cpp", "image_psd.cpp", "image_ico.cpp",
                                     "image_qoi.cpp", "image_im.cpp", "image_misc.cpp",
                                     "image_webp.cpp", "image_lzma.cpp", "image_j2k.cpp",
                                     "image_zstd.cpp")]
HEADERS = [_CSRC / "image_common.h"]
MODES = ("1", "L", "P", "I;16", "LA", "RGB", "RGBA", "I;16B", "I", "F", "CMYK",
         "LAB")   # mode codes

UNKNOWN = ("not an image file PIL identifies (JPEG, PNG, BMP, CUR, PCX, DDS, ICO, TIFF, GIF, "
           "JPEG 2000, IM, MSP, PNM, PFM, PSD, QOI, SGI, SPIDER, SUN, TGA, WebP, XBM and XPM "
           "are read)")

_lib = None


@dataclass(frozen=True)
class Decoded:
    """A decoded file in PIL's mode: ``samples`` [H, W, C] uint8 (uint16
    for I;16 and I;16B, int32 for I, float32 for F); ``palette`` [N, 3]
    uint8 for mode P."""
    samples: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    return native.compile_library("libproslam_image_extra", SOURCES, ["-lz"], HEADERS)


def library() -> ctypes.CDLL:
    """The loaded library, compiling it first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ints = [ctypes.POINTER(ctypes.c_int)] * 5
        lib.pslx_decode_file.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.pslx_decode_file.argtypes = ([ctypes.c_char_p] + ints
                                         + [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                            ctypes.c_char_p, ctypes.c_int])
        lib.pslx_encode_jpeg_gray.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.pslx_encode_jpeg_gray.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
        lib.pslx_encode_gif_gray.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.pslx_encode_gif_gray.argtypes = lib.pslx_encode_jpeg_gray.argtypes
        lib.pslx_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _take(ptr, count: int, lib) -> bytearray:
    """The library's malloc'd buffer, copied (writable) and freed."""
    data = bytearray(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * count)).contents)
    lib.pslx_free(ptr)
    return data


def decode(path: str) -> Decoded:
    """An image file PIL identifies (JPEG, PNG, BMP, TIFF, GIF, PNM / PFM,
    JPEG 2000 and the rest of the module docstring's list) -> its samples
    in PIL's mode; ValueError naming the file and the reason when the
    library does not read it."""
    lib = library()
    w, h, c, d, m, n_pal = (ctypes.c_int() for _ in range(6))
    pal = ctypes.create_string_buffer(768)
    err = ctypes.create_string_buffer(512)
    ptr = lib.pslx_decode_file(os.fsencode(path), *(ctypes.byref(v) for v in (w, h, c, d, m)),
                               pal, ctypes.byref(n_pal), err, len(err))
    if not ptr:
        raise ValueError(f"cannot read {path}: {err.value.decode()}")
    mode = MODES[m.value]
    dtype = {8: np.uint8, 16: np.uint16, 32: np.float32 if mode == "F" else np.int32}[d.value]
    count = w.value * h.value * c.value * np.dtype(dtype).itemsize
    samples = np.frombuffer(_take(ptr, count, lib), dtype).reshape(h.value, w.value, c.value)
    palette = (np.frombuffer(pal.raw[:n_pal.value], np.uint8).reshape(-1, 3)
               if mode == "P" else None)
    return Decoded(samples, mode, palette)


def luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's integer RGB -> L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    x = rgb.astype(np.int64)
    return (19595 * x[..., 0] + 38470 * x[..., 1] + 7471 * x[..., 2] + 0x8000) >> 16


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB: 255 - K - C * (255 - K) / 255 per channel, its
    rounded MULDIV255, clipped."""
    x = cmyk.astype(np.int64)
    nk = 255 - x[..., 3:4]
    t = x[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)


def gray_f32(img: Decoded, path: str = "") -> np.ndarray:
    """The JAX package's ``load_gray`` of a file PIL opens in ``img.mode``:
    float32 [H, W] in 0..255; ValueError (naming ``path``) for LAB, which
    PIL does not convert to L."""
    s = img.samples
    if img.mode == "LAB":
        raise ValueError(f"cannot read {path} as gray: PIL has no conversion from LAB to L")
    if img.mode in ("I;16", "I"):
        return np.ascontiguousarray((s[:, :, 0] / 256).astype(np.float32))
    if img.mode == "I;16B":       # PIL's I;16B -> L clips
        gray = np.minimum(s[:, :, 0], 255)
    elif img.mode == "F":         # F -> L: clipped, truncated, NaN to 0
        gray = np.trunc(np.clip(np.nan_to_num(s[:, :, 0], nan=0, posinf=255, neginf=0), 0, 255))
    elif img.mode == "CMYK":      # through RGB, as PIL converts
        gray = luma(cmyk_to_rgb(s))
    elif img.mode == "1":
        gray = s[:, :, 0].astype(np.int64) * 255
    elif img.mode == "P":
        palette = np.zeros((256, 3), np.uint8)   # PIL's entries past the PLTE are black
        palette[:len(img.palette)] = img.palette
        gray = luma(palette[s[:, :, 0]])
    elif img.mode in ("RGB", "RGBA"):
        gray = luma(s[:, :, :3])
    else:   # L, LA
        gray = s[:, :, 0]
    return np.ascontiguousarray(gray, dtype=np.float32)


def depth_f32(img: Decoded) -> np.ndarray:
    """The JAX package's ``load_depth``: the first channel as PIL holds it."""
    return np.ascontiguousarray(img.samples[:, :, 0], dtype=np.float32)


def _encode(name: str, gray: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(gray, np.uint8)
    lib = library()
    size = ctypes.c_int()
    ptr = getattr(lib, f"pslx_encode_{name}_gray")(arr.tobytes(), arr.shape[1], arr.shape[0],
                                                    ctypes.byref(size))
    if not ptr:
        raise RuntimeError(f"the {name.upper()} writer failed")
    return bytes(_take(ptr, size.value, lib))


def encode_jpeg_gray(gray: np.ndarray) -> bytes:
    """uint8 [H, W] -> a baseline JFIF JPEG as PIL writes it by default
    (standard tables at quality 75, no optimisation)."""
    return _encode("jpeg", gray)


def encode_gif_gray(gray: np.ndarray) -> bytes:
    """uint8 [H, W] -> the GIF PIL writes for mode L: the used gray levels as
    the colour table, interlaced from 16 x 16 up, LZW."""
    return _encode("gif", gray)


def encode_tga_gray(gray: np.ndarray) -> bytes:
    """uint8 [H, W] -> the TGA PIL writes for mode L: uncompressed type 3,
    rows bottom-up, the TGA 2.0 footer."""
    arr = np.ascontiguousarray(gray, np.uint8)
    rows, cols = arr.shape
    return (struct.pack("<BBBHHBHHHHBB", 0, 0, 3, 0, 0, 0, 0, 0, cols, rows, 8, 0)
            + arr[::-1].tobytes() + bytes(8) + b"TRUEVISION-XFILE.\0")


def encode_sgi_gray(gray: np.ndarray, name: str) -> bytes:
    """uint8 [H, W] -> the SGI PIL writes for mode L to a file called
    ``name``: the 512-byte header (the file's stem, ASCII, as the image
    name), one byte a sample, rows bottom-up."""
    arr = np.ascontiguousarray(gray, np.uint8)
    rows, cols = arr.shape
    stem = os.path.splitext(os.path.basename(name))[0].encode("ascii", "ignore")[:79]
    header = struct.pack(">hBBHHHHll4s80sl404s", 474, 0, 1, 1 if rows == 1 else 2, cols, rows,
                         1, 0, 255, b"", stem, 0, b"")
    return header + arr[::-1].tobytes()


def encode_pcx_gray(gray: np.ndarray) -> bytes:
    """uint8 [H, W] -> the PCX PIL writes for mode L: version 5, 8 bits, one
    plane, rows run-length coded as PcxEncode.c codes them (runs of up to
    63, a single byte below 0xC0 as itself, rows padded to an even length
    with zeros), the gray ramp as the 256-colour palette."""
    arr = np.ascontiguousarray(gray, np.uint8)
    rows, cols = arr.shape
    stride = cols + cols % 2
    out = bytearray(struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, cols - 1, rows - 1, 100, 100)
                    + bytes(24) + b"\xff" * 24 + bytes([0, 1])
                    + struct.pack("<HHHH", stride, 1, cols, rows) + bytes(54))
    for row in arr:
        # runs of equal bytes, each cut into pieces of at most 63
        starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
        for start, end in zip(starts, np.r_[starts[1:], cols]):
            value, n = int(row[start]), int(end - start)
            while n > 0:
                k = min(n, 63)
                out += bytes([value]) if k == 1 and value < 0xC0 else bytes([0xC0 | k, value])
                n -= k
        out += bytes(stride - cols)
    out += b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    return bytes(out)


def encode_dds_gray(gray: np.ndarray) -> bytes:
    """uint8 [H, W] -> the DDS PIL writes for mode L: the 128-byte header
    (8-bit luminance, pitch W), the rows top-down."""
    arr = np.ascontiguousarray(gray, np.uint8)
    rows, cols = arr.shape
    header = struct.pack("<4s7I44x4I4I5I", b"DDS ", 124, 0x100F, rows, cols, cols, 0, 0, 32,
                         0x20000, 0, 8, 0xFF000000, 0xFF000000, 0xFF000000, 0, 0x1000, 0, 0, 0,
                         0)
    return header + arr.tobytes()


def encode_im_gray(gray: np.ndarray, name: str) -> bytes:
    """uint8 [H, W] -> the IM PIL writes for mode L to a file called
    ``name``: the text header (image type, the file's name, size, one
    frame) padded with NULs to 511 bytes, 0x1A, the rows bottom-up."""
    arr = np.ascontiguousarray(gray, np.uint8)
    rows, cols = arr.shape
    stem, ext = os.path.splitext(os.path.basename(name))
    header = (f"Image type: Greyscale image\r\nName: {stem[:92 - len(ext)]}{ext}\r\n"
              f"Image size (x*y): {cols}*{rows}\r\nFile size (no of images): 1\r\n"
              ).encode("ascii")
    return header + bytes(511 - len(header)) + b"\x1a" + arr[::-1].tobytes()


def encode_tiff_gray(gray: np.ndarray) -> bytes:
    """uint8 [H, W] -> the uncompressed little-endian TIFF PIL's own writer
    gives mode L: one strip, nine tags, the pixels at byte 122."""
    arr = np.ascontiguousarray(gray, np.uint8)
    rows, cols = arr.shape
    tags = [(256, 4, cols), (257, 4, rows), (258, 3, 8), (259, 3, 1), (262, 3, 1),
            (273, 4, 122), (278, 4, rows), (279, 4, arr.size), (284, 3, 1)]
    ifd = b"".join(struct.pack("<HHI", tag, kind, 1)
                   + struct.pack("<I" if kind == 4 else "<H2x", value)
                   for tag, kind, value in tags)
    return b"II*\0" + struct.pack("<IH", 8, len(tags)) + ifd + bytes(4) + arr.tobytes()


def encode_bmp_gray(gray: np.ndarray) -> bytes:
    """uint8 [H, W] -> an 8-bit BMP with a gray palette, as PIL writes mode L
    (96 dpi, rows bottom-up, padded to 4 bytes)."""
    arr = np.ascontiguousarray(gray, np.uint8)
    rows, cols = arr.shape
    stride = (cols + 3) & ~3
    offset = 14 + 40 + 256 * 4
    ppm = int(96 * 39.3701 + 0.5)
    ramp = np.arange(256, dtype=np.uint8)   # palette entries (i, i, i, 0)
    pixels = np.zeros((rows, stride), np.uint8)
    pixels[:, :cols] = arr[::-1]
    return (b"BM" + struct.pack("<IIIIiiHHIIiiII", offset + pixels.size, 0, offset, 40, cols,
                                rows, 1, 8, 0, pixels.size, ppm, ppm, 256, 256)
            + np.stack([ramp, ramp, ramp, np.zeros_like(ramp)], -1).tobytes()
            + pixels.tobytes())
