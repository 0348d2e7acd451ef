"""Bundled KITTI and ICL readers emitting numpy arrays, with zlib/numpy
PNG and PGM decoders.

Port of the stereo and RGB-D parts of srrg2_proslam_tpu/io/datasets.py.
The decoders need neither PIL nor the JAX package: PNG reads 8- and 16-bit
gray, gray+alpha, RGB and RGBA non-interlaced images with all five
scanline filters; PGM reads binary P5 with 8- or 16-bit (big-endian)
samples.  Colour becomes gray as the JAX package's native decoder makes
it (io/native.py ``to_gray_f32``): 0.299 R + 0.587 G + 0.114 B in
float64, then float32.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..ops.pinhole import Camera

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters -> uint8 [rows, stride]."""
    lines = raw.reshape(rows, stride + 1)
    kinds = lines[:, 0]
    data = lines[:, 1:].astype(np.int32)
    out = np.zeros((rows, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(rows):
        f, line = kinds[y], data[y]
        if f == 0:      # None
            cur = line
        elif f == 1:    # Sub: running sum per byte lane, mod 256
            cur = line.copy()
            for lane in range(bpp):
                cur[lane::bpp] = np.cumsum(line[lane::bpp]) & 0xFF
        elif f == 2:    # Up
            cur = (line + prev) & 0xFF
        elif f in (3, 4):   # Average, Paeth: sequential along the row
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {f}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def _decode_png(blob: bytes, path: str) -> np.ndarray:
    """PNG -> uint8 or uint16 samples, [H, W] (gray) or [H, W, C]."""
    pos, idat, header = 8, [], None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        chunk = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"IEND":
            break
    width, height, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS or depth not in (8, 16) or interlace != 0:
        raise ValueError(f"PNG: only non-interlaced 8/16-bit gray, gray+alpha, RGB or "
                         f"RGBA is supported ({path}: color {color}, depth {depth}, "
                         f"interlace {interlace})")
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pix = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    pix = pix.reshape(height, width, channels)
    return pix[:, :, 0] if channels == 1 else pix


def _pnm_tokens(blob: bytes, count: int):
    """The first ``count`` integer header fields of a PNM after the magic,
    skipping whitespace and comments; returns (values, offset after the
    single whitespace byte that ends the header)."""
    pos, values = 2, []
    while len(values) < count:
        while pos < len(blob) and (blob[pos:pos + 1].isspace() or blob[pos] == ord("#")):
            if blob[pos] == ord("#"):
                while pos < len(blob) and blob[pos] != ord("\n"):
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(blob) and blob[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            raise ValueError("PGM: malformed header")
        values.append(int(blob[start:pos]))
    return values, pos + 1


def _decode_pgm(blob: bytes, path: str) -> np.ndarray:
    """Binary P5 PGM -> uint8 (maxval <= 255) or uint16 samples [H, W]."""
    if blob[:2] != b"P5":
        raise ValueError(f"PGM: only binary P5 is supported ({path})")
    (width, height, maxval), pos = _pnm_tokens(blob, 3)
    dtype = ">u2" if maxval > 255 else np.uint8
    n = width * height
    pix = np.frombuffer(blob, dtype, count=n, offset=pos).reshape(height, width)
    return pix.astype(np.uint16 if maxval > 255 else np.uint8)


def decode(path: str) -> np.ndarray:
    """A PNG or binary PGM file -> its samples, [H, W] or [H, W, C]."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] == _PNG_SIGNATURE:
        return _decode_png(blob, path)
    if blob[:2] == b"P5":
        return _decode_pgm(blob, path)
    raise ValueError(f"not a PNG or binary PGM file: {path}")


def load_gray(path: str) -> np.ndarray:
    """Image -> float32 gray [H, W] in 0..255 (16-bit samples / 256)."""
    arr = decode(path)
    scale_16 = arr.dtype == np.uint16
    if arr.ndim == 3:
        if arr.shape[2] >= 3:
            arr = 0.299 * arr[:, :, 0] + 0.587 * arr[:, :, 1] + 0.114 * arr[:, :, 2]
        else:
            arr = arr[:, :, 0]
    arr = np.asarray(arr, np.float32)
    if scale_16:
        arr = arr / 256.0
    return np.ascontiguousarray(arr)


def load_depth(path: str) -> np.ndarray:
    """16-bit depth image (binary PGM or PNG) -> float32 raw units [H, W];
    the adaptor scales to metres."""
    arr = decode(path)
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return np.ascontiguousarray(arr, dtype=np.float32)


def kitti_camera(rows: int = 376, cols: int = 1241) -> Camera:
    """KITTI odometry seq-00 rectified intrinsics."""
    return Camera(fx=718.856, fy=718.856, cx=607.193, cy=185.216,
                  rows=rows, cols=cols, baseline_px=386.1448,
                  range_min=0.1, range_max=300.0)


def icl_camera() -> Camera:
    """ICL-NUIM intrinsics (note the negated fy)."""
    return Camera(fx=481.2, fy=-481.0, cx=319.5, cy=239.5,
                  rows=480, cols=640, range_min=0.1, range_max=20.0)


@dataclass
class StereoFrame:
    timestamp: float
    left: np.ndarray
    right: np.ndarray
    gt_pose: Optional[np.ndarray] = None  # 4x4, world_from_camera


@dataclass
class RGBDFrame:
    timestamp: float
    intensity: np.ndarray
    depth: np.ndarray   # raw units; the adaptor applies depth_scale
    gt_pose: Optional[np.ndarray] = None


def _kitti_pose_lines(path: str) -> np.ndarray:
    """KITTI ground truth: rows of 12 floats = row-major 3x4 [R|t]."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float64), (data.shape[0], 1, 1))
    out[:, :3, :] = data
    return out.astype(np.float32)


def iter_bundled_kitti(root: str, sequence: str = "city") -> Iterator[StereoFrame]:
    """The 5-frame (city) / 2-frame (highway) sequences under ``root/kitti``."""
    folder = os.path.join(root, "kitti", sequence)
    lefts = sorted(f for f in os.listdir(folder) if f.startswith("image_left"))
    gt = _kitti_pose_lines(os.path.join(folder, "gt.txt"))
    for i, name in enumerate(lefts):
        # gt.txt holds the whole sequence; index by the frame id in the name
        frame_id = int(re.findall(r"\d+", name)[0])
        yield StereoFrame(
            timestamp=float(i) * 0.1,
            left=load_gray(os.path.join(folder, name)),
            right=load_gray(os.path.join(folder, f"image_right_{frame_id}.png")),
            gt_pose=gt[frame_id] if frame_id < len(gt) else None,
        )


def iter_bundled_icl(root: str) -> Iterator[RGBDFrame]:
    """The 3 bundled ICL-NUIM frames (ids 0, 1, 50) under ``root/icl``."""
    folder = os.path.join(root, "icl")
    for i, frame_id in enumerate((0, 1, 50)):
        yield RGBDFrame(
            timestamp=float(i),
            intensity=load_gray(os.path.join(folder, f"image_rgb_{frame_id}.png")),
            depth=load_depth(os.path.join(folder, f"image_depth_{frame_id}.pgm")),
        )
