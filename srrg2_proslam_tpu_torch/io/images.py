"""The port's second image library: the files the native decoder refuses,
read as the JAX package reads them through PIL.

``csrc/image_extra.cpp`` decodes JPEG (baseline and progressive Huffman;
gray, and YCbCr at any integral sampling such as 4:4:4, 4:2:2, 4:2:0 and
4:1:1; restart intervals), PNG of every colour type, bit depth and
interlace (palette, 1/2/4-bit, Adam7) and uncompressed 8/24/32-bit BMP,
bit for bit as PIL with libjpeg-turbo does, and writes baseline gray JPEG
byte for byte as PIL does by default.  It is compiled with g++ at first use
into the git-ignored ``srrg2_proslam_tpu_torch/build/`` as ``io/native.py``
compiles the repo's decoder; a failed build raises with the compiler's
output.  ``images_plain.decode`` is the plain Python twin it is held to.

A decoded file keeps PIL's mode, and ``gray_f32`` / ``depth_f32`` apply the
JAX package's rule for files that take its PIL branch
(``srrg2_proslam_tpu/io/datasets.py`` ``load_gray`` / ``load_depth``): L,
I and I;16 as they are (16-bit / 256), every other mode through PIL's
``convert("L")`` (integer luma for colour and palette entries, 0/255 for
mode 1); depth is the first channel of the samples as PIL holds them
(palette indices, 0/1, R of RGB).
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

SOURCES = [Path(__file__).resolve().parent / "csrc" / "image_extra.cpp"]
MODES = ("1", "L", "P", "I;16", "LA", "RGB", "RGBA")   # the library's mode codes

_lib = None


@dataclass(frozen=True)
class Decoded:
    """A decoded file in PIL's mode: ``samples`` [H, W, C] uint8 (uint16
    for I;16); ``palette`` [N, 3] uint8 for mode P."""
    samples: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    return native.compile_library("libproslam_image_extra", SOURCES, ["-lz"])


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
        lib.pslx_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _take(ptr, count: int, lib) -> bytes:
    data = bytes(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * count)).contents)
    lib.pslx_free(ptr)
    return data


def decode(path: str) -> Decoded:
    """A JPEG, PNG or BMP file -> its samples in PIL's mode; ValueError
    naming the file and the reason when the library does not read it."""
    lib = library()
    w, h, c, d, m, n_pal = (ctypes.c_int() for _ in range(6))
    pal = ctypes.create_string_buffer(768)
    err = ctypes.create_string_buffer(512)
    ptr = lib.pslx_decode_file(os.fsencode(path), *(ctypes.byref(v) for v in (w, h, c, d, m)),
                               pal, ctypes.byref(n_pal), err, len(err))
    if not ptr:
        raise ValueError(f"cannot read {path}: {err.value.decode()}")
    dtype = np.uint16 if d.value == 16 else np.uint8
    count = w.value * h.value * c.value * np.dtype(dtype).itemsize
    samples = np.frombuffer(_take(ptr, count, lib), dtype).reshape(h.value, w.value, c.value)
    mode = MODES[m.value]
    palette = (np.frombuffer(pal.raw[:n_pal.value], np.uint8).reshape(-1, 3)
               if mode == "P" else None)
    return Decoded(samples, mode, palette)


def luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's integer RGB -> L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    x = rgb.astype(np.int64)
    return (19595 * x[..., 0] + 38470 * x[..., 1] + 7471 * x[..., 2] + 0x8000) >> 16


def gray_f32(img: Decoded) -> np.ndarray:
    """The JAX package's ``load_gray`` of a file PIL opens in ``img.mode``:
    float32 [H, W] in 0..255."""
    s = img.samples
    if img.mode == "I;16":
        return np.ascontiguousarray((s[:, :, 0] / 256).astype(np.float32))
    if img.mode == "1":
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


def encode_jpeg_gray(gray: np.ndarray) -> bytes:
    """uint8 [H, W] -> a baseline JFIF JPEG as PIL writes it by default
    (standard tables at quality 75, no optimisation)."""
    arr = np.ascontiguousarray(gray, np.uint8)
    lib = library()
    size = ctypes.c_int()
    ptr = lib.pslx_encode_jpeg_gray(arr.tobytes(), arr.shape[1], arr.shape[0],
                                    ctypes.byref(size))
    if not ptr:
        raise RuntimeError("the JPEG writer failed")
    return _take(ptr, size.value, lib)


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
