"""Pinhole projection / unprojection with frustum masks.

Port of srrg2_proslam_tpu/ops/pinhole.py: vectorized functions returning
validity masks instead of compacting point vectors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Static pinhole camera intrinsics (same fields as the JAX Camera).

    ``baseline_px`` = fx * b_x, the rectified-stereo baseline in
    pixel-meters.
    """

    fx: float
    fy: float
    cx: float
    cy: float
    rows: int
    cols: int
    baseline_px: float = 0.0
    range_min: float = 0.1
    range_max: float = 1000.0

    @property
    def K(self) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    @property
    def baseline_m(self) -> float:
        return self.baseline_px / self.fx


def project(cam: Camera, pts_cam: torch.Tensor):
    """Camera-frame points [..., N, 3] -> (uv [..., N, 2], in_view [..., N])."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = cam.fx * x / z_safe + cam.cx
    v = cam.fy * y / z_safe + cam.cy
    in_view = (
        (z > cam.range_min)
        & (z < cam.range_max)
        & (u >= 0.0)
        & (u < cam.cols)
        & (v >= 0.0)
        & (v < cam.rows)
    )
    return torch.stack([u, v], dim=-1), in_view


def unproject(cam: Camera, uvd: torch.Tensor):
    """(u, v, depth_m) [..., N, 3] -> (camera-frame points, depth-in-range)."""
    u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
    x = (u - cam.cx) / cam.fx * d
    y = (v - cam.cy) / cam.fy * d
    valid = (d > cam.range_min) & (d < cam.range_max)
    return torch.stack([x, y, d], dim=-1), valid
