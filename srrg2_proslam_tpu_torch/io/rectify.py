"""Radtan undistortion and stereo rectification (EuRoC/ASL real data).

Port of srrg2_proslam_tpu/io/rectify.py (host numpy, once per sequence
for the tables and two bilinear gathers per frame): ``load_asl_sensor_yaml``
reads an ASL ``sensor.yaml`` (pinhole intrinsics, radtan coefficients,
the ``T_BS`` body-from-sensor extrinsic) with a parser of its own for
that subset of YAML (scalars, flow lists that may span lines, one level
of nested mapping), so PyYAML is not needed; ``stereo_rectify`` builds
Bouguet-style rectifying rotations, a shared rectified pinhole and the
remap tables (rectified pixel -> raw source coordinate, the distortion
applied in the forward direction); ``remap`` resamples bilinearly with
edge clamping.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.pinhole import Camera


@dataclass(frozen=True)
class CameraCalib:
    """One physical camera: pinhole + radtan + body-from-sensor extrinsic."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    rows: int = 480
    cols: int = 752
    T_BS: Optional[np.ndarray] = None  # [4,4] sensor-in-body

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], dtype=np.float64)


_YAML_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")


def _yaml_scalar(text: str):
    """A plain YAML 1.1 scalar as PyYAML's safe loader resolves it."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"):
        return True
    if t in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"):
        return False
    if _YAML_INT.match(t):
        return int(t.replace("_", ""))
    if _YAML_FLOAT.match(t):
        low = t.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        return float("nan") if low.endswith("nan") else float(t.replace("_", ""))
    return t


def _yaml_value(text: str):
    text = text.strip()
    if text.startswith("["):
        inner = text[1:text.rindex("]")].strip()
        return [_yaml_scalar(v) for v in inner.split(",")] if inner else []
    return _yaml_scalar(text)


def parse_sensor_yaml(text: str) -> dict:
    """The subset of YAML an ASL ``sensor.yaml`` uses: ``key: value`` lines
    with plain scalars or flow lists (``[a, b, ...]``, possibly over several
    lines), a key with nothing after it opening an indented mapping of such
    lines, ``#`` comments and ``%YAML`` directives."""
    lines = []
    for raw in text.splitlines():
        line = raw.split(" #")[0].rstrip() if not raw.lstrip().startswith("#") else ""
        if line.strip() and not line.lstrip().startswith(("%", "---")):
            lines.append(line)
    doc: dict = {}
    stack = [(-1, doc)]          # (indent, mapping) of the open mappings
    i = 0
    while i < len(lines):
        line = lines[i]
        indent = len(line) - len(line.lstrip())
        key, _, rest = line.strip().partition(":")
        while rest.count("[") > rest.count("]"):   # a flow list over several lines
            i += 1
            rest += " " + lines[i].strip()
        while indent <= stack[-1][0]:
            stack.pop()
        target = stack[-1][1]
        if rest.strip():
            target[key.strip()] = _yaml_value(rest)
        else:
            target[key.strip()] = {}
            stack.append((indent, target[key.strip()]))
        i += 1
    return doc


def load_asl_sensor_yaml(path: str) -> CameraCalib:
    """Parse an EuRoC ASL ``sensor.yaml`` into a CameraCalib."""
    with open(path) as f:
        doc = parse_sensor_yaml(f.read())
    fu, fv, cu, cv = doc["intrinsics"]
    dist = list(doc.get("distortion_coefficients", [0, 0, 0, 0]))
    cols, rows = doc["resolution"]
    T_BS = None
    if "T_BS" in doc:
        data = doc["T_BS"]["data"] if isinstance(doc["T_BS"], dict) else doc["T_BS"]
        T_BS = np.asarray(data, dtype=np.float64).reshape(4, 4)
    return CameraCalib(fx=float(fu), fy=float(fv), cx=float(cu), cy=float(cv),
                       k1=float(dist[0]), k2=float(dist[1]),
                       p1=float(dist[2]), p2=float(dist[3]),
                       rows=int(rows), cols=int(cols), T_BS=T_BS)


def _log_so3(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(cos)
    if angle < 1e-12:
        return np.zeros(3)
    if angle > np.pi - 1e-3:
        # near-pi: the sin-based formula is numerically unstable (and no
        # physical stereo rig has its cameras rotated ~180 deg apart) —
        # refuse with a clear error instead of returning NaNs
        raise ValueError(
            f"relative camera rotation {np.degrees(angle):.1f} deg is "
            "near 180 deg; refusing to rectify a pathological calibration")
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * angle / (2.0 * np.sin(angle))


def _exp_so3(w: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(w)
    if angle < 1e-12:
        return np.eye(3)
    a = w / angle
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _distort_radtan(x: np.ndarray, y: np.ndarray, c: CameraCalib):
    """Forward radtan model: normalized ideal -> normalized distorted."""
    r2 = x * x + y * y
    radial = 1.0 + c.k1 * r2 + c.k2 * r2 * r2
    xd = x * radial + 2.0 * c.p1 * x * y + c.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + c.p1 * (r2 + 2.0 * y * y) + 2.0 * c.p2 * x * y
    return xd, yd


@dataclass(frozen=True)
class StereoRectification:
    """Rectifying rotations + shared pinhole + per-camera remap tables."""

    R_rect0: np.ndarray      # [3,3] rectified-from-cam0
    R_rect1: np.ndarray      # [3,3] rectified-from-cam1
    camera: Camera           # shared rectified pinhole (baseline_px set)
    baseline_m: float
    map0: np.ndarray         # [H,W,2] float32 raw (x, y) source per rect pixel
    map1: np.ndarray
    T_B_rect: Optional[np.ndarray] = None  # rectified-cam0-in-body extrinsic


def _remap_table(calib: CameraCalib, R_rect: np.ndarray, cam: Camera) -> np.ndarray:
    """Rectified pixel grid -> raw source coordinates through R^T + radtan."""
    us = (np.arange(cam.cols, dtype=np.float64) - cam.cx) / cam.fx
    vs = (np.arange(cam.rows, dtype=np.float64) - cam.cy) / cam.fy
    xg, yg = np.meshgrid(us, vs)
    rays = np.stack([xg, yg, np.ones_like(xg)], axis=-1)  # rectified frame
    rays = rays @ R_rect  # == (R_rect^T @ ray^T)^T : back into the raw camera
    x = rays[..., 0] / rays[..., 2]
    y = rays[..., 1] / rays[..., 2]
    xd, yd = _distort_radtan(x, y, calib)
    src_x = calib.fx * xd + calib.cx
    src_y = calib.fy * yd + calib.cy
    return np.stack([src_x, src_y], axis=-1).astype(np.float32)


def stereo_rectify(c0: CameraCalib, c1: CameraCalib,
                   T_c1_c0: Optional[np.ndarray] = None) -> StereoRectification:
    """Bouguet-style rectification of a calibrated stereo pair.

    ``T_c1_c0`` maps cam0 coordinates to cam1 coordinates; when omitted it is
    derived from the two ``T_BS`` extrinsics (inv(T_BS1) @ T_BS0).  Returns
    rotations such that the rectified pair is a pure x-translation rig with
    horizontal epipolar lines, plus the shared rectified camera and the remap
    tables that produce rectified images from raw ones.
    """
    if T_c1_c0 is None:
        if c0.T_BS is None or c1.T_BS is None:
            raise ValueError("need T_c1_c0 or both T_BS extrinsics")
        T_c1_c0 = np.linalg.inv(c1.T_BS) @ c0.T_BS
    R = T_c1_c0[:3, :3]
    t = T_c1_c0[:3, 3]

    # split the relative rotation evenly between the two cameras (Bouguet):
    # minimizes the reprojection distortion each image suffers
    om = _log_so3(R)
    A0 = _exp_so3(om / 2.0)        # applied to cam0
    A1 = _exp_so3(-om / 2.0)       # applied to cam1;  A1 @ R @ A0^T == I
    t_half = A1 @ t

    # common frame: x-axis along the baseline so epipolar lines go horizontal
    ex = -t_half / np.linalg.norm(t_half)      # W @ t_half == [-b, 0, 0]
    ey = np.cross(np.array([0.0, 0.0, 1.0]), ex)
    ey_norm = np.linalg.norm(ey)
    if ey_norm < 1e-6:
        # baseline (near-)parallel to the optical axis: no rotation can make
        # epipolar lines horizontal — a forward-translation "stereo" rig is
        # not rectifiable
        raise ValueError(
            "stereo baseline is parallel to the optical axis; "
            "cannot build a horizontal-epipolar rectification")
    ey /= ey_norm
    ez = np.cross(ex, ey)
    W = np.stack([ex, ey, ez], axis=0)
    R_rect0 = W @ A0
    R_rect1 = W @ A1
    baseline_m = float(np.linalg.norm(t_half))

    fx = 0.5 * (c0.fx + c1.fx)
    fy = 0.5 * (c0.fy + c1.fy)
    rows, cols = c0.rows, c0.cols
    cam = Camera(fx=fx, fy=fy, cx=cols / 2.0, cy=rows / 2.0,
                 rows=rows, cols=cols, baseline_px=fx * baseline_m,
                 range_min=0.1, range_max=100.0)
    T_B_rect = None
    if c0.T_BS is not None:
        T_B_rect = c0.T_BS.copy()
        T_B_rect[:3, :3] = c0.T_BS[:3, :3] @ R_rect0.T
    return StereoRectification(
        R_rect0=R_rect0, R_rect1=R_rect1, camera=cam, baseline_m=baseline_m,
        map0=_remap_table(c0, R_rect0, cam),
        map1=_remap_table(c1, R_rect1, cam),
        T_B_rect=T_B_rect,
    )


def remap(image: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Bilinear resample ``image`` at ``table`` (out-of-bounds clamp to edge).

    Clamping instead of zero-filling avoids manufacturing hard synthetic
    edges around the valid region — zero borders make FAST fire at
    consistent rows in BOTH cameras and spurious border features can pass
    epipolar matching into the map; the clamped
    extension is locally flat along the extrapolated direction, which the
    corner test rejects.  ``remap_valid_mask`` reports the exactly-valid
    region for callers that want to crop (OpenCV crops to the valid ROI).
    """
    H, W = image.shape
    sx = np.clip(table[..., 0], 0.0, W - 1.001)
    sy = np.clip(table[..., 1], 0.0, H - 1.001)
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    fx = (sx - x0).astype(np.float32)
    fy = (sy - y0).astype(np.float32)
    x0c = np.clip(x0, 0, W - 2)
    y0c = np.clip(y0, 0, H - 2)
    v = ((1 - fy) * ((1 - fx) * image[y0c, x0c] + fx * image[y0c, x0c + 1])
         + fy * ((1 - fx) * image[y0c + 1, x0c] + fx * image[y0c + 1, x0c + 1]))
    return v.astype(np.float32)


def remap_valid_mask(table: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Boolean [H,W] mask of rectified pixels whose source is in-bounds."""
    sx = table[..., 0]
    sy = table[..., 1]
    return ((sx >= 0) & (sx <= cols - 1.001)
            & (sy >= 0) & (sy <= rows - 1.001))


def find_euroc_rectification(sequence_dir: str) -> Optional[StereoRectification]:
    """Build a rectification from ``mav0/cam{0,1}/sensor.yaml`` if present."""
    y0 = os.path.join(sequence_dir, "mav0", "cam0", "sensor.yaml")
    y1 = os.path.join(sequence_dir, "mav0", "cam1", "sensor.yaml")
    if not (os.path.exists(y0) and os.path.exists(y1)):
        return None
    return stereo_rectify(load_asl_sensor_yaml(y0), load_asl_sensor_yaml(y1))
