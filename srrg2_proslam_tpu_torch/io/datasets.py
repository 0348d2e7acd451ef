"""Dataset readers and writers emitting host numpy arrays.

Port of srrg2_proslam_tpu/io/datasets.py, needing neither PIL nor the JAX
package.  An image decodes as the JAX package decodes it: through the
native library (io/native.py, the repo's C++ decoder built at first use)
when that reads the file, else through the port's second image library
(io/images.py: JPEG, PNG, BMP, TIFF, GIF, PNM, PFM and PIL's other
raster formats in PIL's modes),
which stands where the JAX package calls PIL and gives PIL's result; a
file neither reads raises.  The readers of dataset folders take their
files through the native prefetcher and decode the files it refuses on
the calling thread.  ``decode_plain`` is the plain Python decoder the native
one is held to: PNG 8- and 16-bit gray, gray+alpha, RGB and RGBA
non-interlaced with all five scanline filters, binary P5 PGM with 8- or
16-bit (big-endian) samples.  On the native path colour becomes gray as
0.299 R + 0.587 G + 0.114 B in float64, then float32; on the other, as
PIL's integer luma.  ``save_gray`` writes 8-bit PNG (zlib), PGM (also
under .pbm / .ppm / .pnm / .pfm, as PIL writes mode L there), baseline
JPEG (quality 75), 8-bit BMP, uncompressed TIFF, GIF, TGA, SGI, PCX, DDS
or IM by the file's extension, byte for byte as PIL does but for PNG.

Layouts: the bundled test data (``test_data/kitti/*``, ``test_data/icl``);
KITTI odometry (``image_0/ image_1/ times.txt``); TUM RGB-D (``rgb.txt
depth.txt``, nearest-timestamp pairing, 16-bit PNG depth); EuRoC ASL
(``mav0/cam{0,1}/data``, rectified through io/rectify.py when the
``sensor.yaml`` files are present); Malaga extracts (``Images/*_left*``,
JPEG or PNG).  Trajectories are written in the
KITTI and TUM formats.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from ..ops.pinhole import Camera
from . import images, native

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


def decode_plain(path: str) -> np.ndarray:
    """A PNG or binary PGM file -> its samples, [H, W] or [H, W, C] (the
    plain Python decoder)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] == _PNG_SIGNATURE:
        return _decode_png(blob, path)
    if blob[:2] == b"P5":
        return _decode_pgm(blob, path)
    raise ValueError(f"not a PNG or binary PGM file: {path}")


def _read(path: str):
    """A file's samples as the native decoder gives them, or, when it does
    not read the file, as io/images.py does (an ``images.Decoded``)."""
    arr = native.try_decode(path)
    return images.decode(path) if arr is None else arr


def _gray(item, path: str = "") -> np.ndarray:
    if isinstance(item, images.Decoded):
        return images.gray_f32(item, path)
    return native.to_gray_f32(item)


def _depth(item) -> np.ndarray:
    if isinstance(item, images.Decoded):
        return images.depth_f32(item)
    arr = item[:, :, 0] if item.ndim == 3 else item
    return np.ascontiguousarray(arr, dtype=np.float32)


def load_gray(path: str) -> np.ndarray:
    """Image -> float32 gray [H, W] in 0..255 (16-bit samples / 256)."""
    return _gray(_read(path), path)


def load_depth(path: str) -> np.ndarray:
    """16-bit depth image (binary PGM or PNG) -> float32 raw units [H, W];
    the adaptor scales to metres.  Other files give their first channel."""
    return _depth(_read(path))


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_gray(path: str, image) -> None:
    """Write a gray [H, W] image (0..255, clipped, truncated to uint8) in the
    format the extension names: 8-bit PNG, binary PGM (.pgm, and .pbm /
    .ppm / .pnm / .pfm, where PIL writes mode L as P5 too), baseline JPEG
    (quality 75), 8-bit BMP, uncompressed TIFF, GIF, TGA (.tga .icb .vda
    .vst), SGI (.sgi .rgb .rgba .bw), PCX, DDS or IM, each as PIL writes
    it; ValueError otherwise (PIL writes no mode-L file for .qoi, .msp,
    .xbm, .blp or .psd; its ICO frames are PNGs of its own zlib)."""
    arr = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    rows, cols = arr.shape
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".pbm", ".ppm", ".pnm", ".pfm"):   # PIL writes mode L as P5 under each
        blob = f"P5\n{cols} {rows}\n255\n".encode() + arr.tobytes()
    elif ext == ".png":
        lines = np.zeros((rows, cols + 1), np.uint8)   # filter byte 0 (None)
        lines[:, 1:] = arr
        blob = (_PNG_SIGNATURE
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", cols, rows, 8, 0, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(lines.tobytes(), 6))
                + _png_chunk(b"IEND", b""))
    elif ext in (".jpg", ".jpeg"):
        blob = images.encode_jpeg_gray(arr)
    elif ext == ".bmp":
        blob = images.encode_bmp_gray(arr)
    elif ext in (".tif", ".tiff"):
        blob = images.encode_tiff_gray(arr)
    elif ext == ".gif":
        blob = images.encode_gif_gray(arr)
    elif ext in (".tga", ".icb", ".vda", ".vst"):
        blob = images.encode_tga_gray(arr)
    elif ext in (".bw", ".rgb", ".rgba", ".sgi"):
        blob = images.encode_sgi_gray(arr, path)
    elif ext == ".pcx":
        blob = images.encode_pcx_gray(arr)
    elif ext == ".dds":
        blob = images.encode_dds_gray(arr)
    elif ext == ".im":
        blob = images.encode_im_gray(arr, path)
    else:
        raise ValueError(f"save_gray: no writer for {ext or 'a name without extension'!r} "
                         f"({path}); use .png, .pgm, .pbm, .ppm, .pnm, .pfm, .jpg, .jpeg, "
                         ".bmp, .tif, .tiff, .gif, .tga, .icb, .vda, .vst, .sgi, .rgb, .rgba, "
                         ".bw, .pcx, .dds or .im")
    with open(path, "wb") as f:
        f.write(blob)


def read_pfm(path: str) -> np.ndarray:
    """SceneFlow PFM: 'Pf'/'PF' header, 'W H', a scale whose sign gives the
    byte order, float32 rows bottom-up -> the first channel, top-down,
    [H, W] float32."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header not in ("Pf", "PF"):
            raise ValueError(f"not a PFM file: {path} (header {header!r})")
        dims = f.readline().decode("latin-1").strip()
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1").strip()
        w, h = map(int, re.split(r"\s+", dims))
        scale = float(f.readline().decode("latin-1").strip())
        count = w * h * (3 if header == "PF" else 1)
        data = np.frombuffer(f.read(count * 4), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, -1)[..., 0]
    return np.ascontiguousarray(img[::-1]).astype(np.float32)


def write_pfm(path: str, image: np.ndarray) -> None:
    """Write a [H, W] float32 image as a little-endian gray PFM."""
    arr = np.asarray(image, np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(arr[::-1]).astype("<f4").tobytes())


def kitti_camera(rows: int = 376, cols: int = 1241) -> Camera:
    """KITTI odometry seq-00 rectified intrinsics."""
    return Camera(fx=718.856, fy=718.856, cx=607.193, cy=185.216,
                  rows=rows, cols=cols, baseline_px=386.1448,
                  range_min=0.1, range_max=300.0)


def icl_camera() -> Camera:
    """ICL-NUIM intrinsics (note the negated fy)."""
    return Camera(fx=481.2, fy=-481.0, cx=319.5, cy=239.5,
                  rows=480, cols=640, range_min=0.1, range_max=20.0)


def tum_camera() -> Camera:
    """TUM RGB-D (freiburg1) default pinhole intrinsics."""
    return Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                  rows=480, cols=640, range_min=0.1, range_max=20.0)


def euroc_camera() -> Camera:
    """EuRoC MAV cam0 intrinsics (rectified model)."""
    return Camera(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                  rows=480, cols=752, baseline_px=458.654 * 0.11,
                  range_min=0.1, range_max=100.0)


def malaga_camera() -> Camera:
    """Malaga urban dataset rectified stereo intrinsics."""
    return Camera(fx=795.11588, fy=795.11588, cx=517.12973, cy=395.59665,
                  rows=768, cols=1024, baseline_px=795.11588 * 0.119571,
                  range_min=0.1, range_max=300.0)


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


def _decoded(paths: List[str]) -> Iterator:
    """``_read`` of each of ``paths``, in order: the native prefetcher
    decodes ahead; a file it refuses is decoded by io/images.py here."""
    if not paths:
        return
    with native.Prefetcher(paths) as pf:
        for path in paths:
            arr = pf.next_or_none()
            yield images.decode(path) if arr is None else arr


def _pairs(pairs, to_a, to_b) -> Iterator[tuple]:
    """Decode (path_a, path_b) pairs in order -> (to_a(a), to_b(b))."""
    it = _decoded([p for pair in pairs for p in pair])
    for _ in pairs:
        yield to_a(next(it)), to_b(next(it))


def iter_kitti_odometry(sequence_dir: str, gt_file: Optional[str] = None,
                        start: int = 0, count: Optional[int] = None) -> Iterator[StereoFrame]:
    """A KITTI odometry sequence folder (image_0/, image_1/, times.txt)."""
    left_dir = os.path.join(sequence_dir, "image_0")
    right_dir = os.path.join(sequence_dir, "image_1")
    names = sorted(os.listdir(left_dir))
    times_path = os.path.join(sequence_dir, "times.txt")
    times = (np.loadtxt(times_path) if os.path.exists(times_path)
             else np.arange(len(names), dtype=np.float64) * 0.1)
    gt = _kitti_pose_lines(gt_file) if gt_file else None
    end = len(names) if count is None else min(len(names), start + count)
    pairs = [(os.path.join(left_dir, names[i]), os.path.join(right_dir, names[i]))
             for i in range(start, end)]
    for i, (left, right) in zip(range(start, end),
                                _pairs(pairs, _gray, _gray)):
        yield StereoFrame(timestamp=float(times[i]), left=left, right=right,
                          gt_pose=gt[i] if gt is not None and i < len(gt) else None)


def _tum_list(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, name = line.split()[:2]
            out.append((float(ts), name))
    return out


def iter_tum_rgbd(sequence_dir: str, max_dt: float = 0.02,
                  count: Optional[int] = None) -> Iterator[RGBDFrame]:
    """A TUM RGB-D folder: each rgb.txt entry pairs with the nearest
    depth.txt entry within ``max_dt`` seconds."""
    rgb = _tum_list(os.path.join(sequence_dir, "rgb.txt"))
    depth = _tum_list(os.path.join(sequence_dir, "depth.txt"))
    d_times = np.array([t for t, _ in depth])
    frames = []
    for ts, rgb_name in rgb:
        j = int(np.argmin(np.abs(d_times - ts)))
        if abs(d_times[j] - ts) > max_dt:
            continue
        frames.append((ts, rgb_name, depth[j][1]))
        if count is not None and len(frames) >= count:
            break
    pairs = [(os.path.join(sequence_dir, r), os.path.join(sequence_dir, d))
             for _, r, d in frames]
    for (ts, _, _), (intensity, dep) in zip(frames,
                                            _pairs(pairs, _gray, _depth)):
        yield RGBDFrame(timestamp=ts, intensity=intensity, depth=dep)


def iter_euroc_stereo(sequence_dir: str, count: Optional[int] = None,
                      rectify: bool = True) -> Iterator[StereoFrame]:
    """EuRoC ASL layout: mav0/cam0/data, mav0/cam1/data (ns timestamps).

    With ``mav0/cam{0,1}/sensor.yaml`` present the raw radtan-distorted,
    non-coplanar images are undistorted and rectified (io/rectify.py);
    ``euroc_rectified_camera`` gives the matching pinhole model.
    """
    from .rectify import find_euroc_rectification, remap

    cam0 = os.path.join(sequence_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(sequence_dir, "mav0", "cam1", "data")
    rect = find_euroc_rectification(sequence_dir) if rectify else None
    names1 = set(os.listdir(cam1))
    names = [n for n in sorted(os.listdir(cam0)) if n in names1][:count]
    pairs = [(os.path.join(cam0, n), os.path.join(cam1, n)) for n in names]
    for name, (left, right) in zip(names, _pairs(pairs, _gray, _gray)):
        if rect is not None:
            left, right = remap(left, rect.map0), remap(right, rect.map1)
        yield StereoFrame(timestamp=float(os.path.splitext(name)[0]) * 1e-9,
                          left=left, right=right)


def euroc_rectified_camera(sequence_dir: str) -> Camera:
    """The pinhole model matching ``iter_euroc_stereo(rectify=True)``."""
    from .rectify import find_euroc_rectification

    rect = find_euroc_rectification(sequence_dir)
    return rect.camera if rect is not None else euroc_camera()


def iter_malaga_stereo(sequence_dir: str, count: Optional[int] = None) -> Iterator[StereoFrame]:
    """Malaga urban extract: an ``Images/`` folder of rectified pairs named
    ``img_CAMERA1_<timestamp>_{left,right}.<ext>``."""
    img_dir = os.path.join(sequence_dir, "Images")
    if not os.path.isdir(img_dir):
        img_dir = sequence_dir
    names = [n for n in sorted(f for f in os.listdir(img_dir) if "_left" in f)
             if os.path.exists(os.path.join(img_dir, n.replace("_left", "_right")))][:count]
    pairs = [(os.path.join(img_dir, n), os.path.join(img_dir, n.replace("_left", "_right")))
             for n in names]
    for i, (name, (left, right)) in enumerate(zip(names, _pairs(pairs, _gray, _gray))):
        stamp = re.findall(r"\d+\.\d+", name)
        yield StereoFrame(timestamp=float(stamp[0]) if stamp else float(i),
                          left=left, right=right)


def write_kitti_trajectory(path: str, poses: List[np.ndarray]) -> None:
    """Rows of row-major 3x4 [R|t]: the KITTI benchmark format."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(T)[:3, :].reshape(-1)))
            f.write("\n")


def write_tum_trajectory(path: str, stamps: List[float], poses: List[np.ndarray]) -> None:
    """Rows of ``timestamp tx ty tz qx qy qz qw``: the TUM format."""
    from .quaternions import rotation_to_quaternion

    with open(path, "w") as f:
        for ts, T in zip(stamps, poses):
            T = np.asarray(T)
            q = rotation_to_quaternion(T[:3, :3])
            t = T[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
