"""Rectified-stereo midpoint triangulation (port of ops/triangulation.py).

    z = baseline_px / (uL - uR),  x = (uL - cx) z / fx,
    y = ((vL + vR)/2 - cy) z / fy
over the whole measurement array, with a validity mask.
"""
from __future__ import annotations

import torch

from .pinhole import Camera


def triangulate_rectified(
    cam: Camera,
    points4: torch.Tensor,
    valid: torch.Tensor,
    minimum_disparity_px: float = 1.0,
    infinity_depth_m: float = 1000.0,
):
    """[N, 4] = (uL, vL, uR, vR) -> (pts_cam [N, 3], valid_out [N])."""
    u_l, v_l, u_r, v_r = points4.unbind(-1)
    disparity = u_l - u_r
    ok = valid & (disparity >= minimum_disparity_px)
    z = torch.where(disparity > 0,
                    cam.baseline_px / torch.clamp_min(disparity, 1e-6),
                    infinity_depth_m)
    x = (u_l - cam.cx) / cam.fx * z
    y = ((v_l + v_r) * 0.5 - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1), ok
