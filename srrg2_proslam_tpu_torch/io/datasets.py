"""Bundled KITTI reader emitting numpy arrays, with a zlib/numpy PNG decoder.

Port of the stereo part of srrg2_proslam_tpu/io/datasets.py.  The decoder
needs neither PIL nor the JAX package: it reads 8- and 16-bit grayscale,
non-interlaced PNGs (the bundled frames are 8-bit gray) with all five
scanline filters.
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


def load_gray(path: str) -> np.ndarray:
    """Grayscale PNG -> float32 [H, W] in 0..255 (16-bit samples / 256)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
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
    if color != 0 or depth not in (8, 16) or interlace != 0:
        raise ValueError(f"PNG: only non-interlaced 8/16-bit gray is supported "
                         f"({path}: color {color}, depth {depth}, interlace {interlace})")
    bpp = depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pix = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        return (pix.view(">u2").astype(np.float64) / 256).astype(np.float32)
    return np.ascontiguousarray(pix, dtype=np.float32)


def kitti_camera(rows: int = 376, cols: int = 1241) -> Camera:
    """KITTI odometry seq-00 rectified intrinsics."""
    return Camera(fx=718.856, fy=718.856, cx=607.193, cy=185.216,
                  rows=rows, cols=cols, baseline_px=386.1448,
                  range_min=0.1, range_max=300.0)


@dataclass
class StereoFrame:
    timestamp: float
    left: np.ndarray
    right: np.ndarray
    gt_pose: Optional[np.ndarray] = None  # 4x4, world_from_camera


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
