"""Per-landmark EKF updates, batched over the whole arena (stereo model).

Port of srrg2_proslam_tpu/ops/ekf.py.  Each landmark's update is an
iterated EKF (two Gauss-Newton sweeps) whose correction is a sequence of
scalar row updates under the diagonal measurement noise — no matrix solve.
The JAX package vmaps one landmark's update; here the arena is a batch
dimension [M, ...] and the row loop is a Python loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .pinhole import Camera


@dataclass(frozen=True)
class LandmarkEKFConfig:
    maximum_covariance_norm_squared: float = 0.25
    maximum_distance_geometry_m2: float = 25.0
    minimum_state_element_covariance: float = 0.01
    measurement_noise_px2: float = 1.0  # diagonal measurement covariance


class EKFResult(NamedTuple):
    position: torch.Tensor    # [M, 3]
    covariance: torch.Tensor  # [M, 3, 3]
    accepted: torch.Tensor    # [M] bool


def _measurement_model_stereo(p_s: torch.Tensor, cam: Camera):
    """(uL, vL, uR, vR) and its [M, 4, 3] Jacobian at sensor points [M, 3]."""
    x, y, z = p_s.unbind(-1)
    iz = 1.0 / torch.clamp_min(z, 1e-3)
    iz2 = iz * iz
    fx_x = cam.fx * x
    fy_y = cam.fy * y
    u_l = fx_x * iz + cam.cx
    v = fy_y * iz + cam.cy
    h = torch.stack([u_l, v, (fx_x - cam.baseline_px) * iz + cam.cx, v], dim=-1)
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -fx_x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -fy_y * iz2], dim=-1)
    row_ur = torch.stack([cam.fx * iz, zero, -(fx_x - cam.baseline_px) * iz2], dim=-1)
    H = torch.stack([row_u, row_v, row_ur, row_v], dim=-2)
    return h, H


def _matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def ekf_update_batch(positions, covariances, measurements, valid,
                     T_world_in_sensor, cam: Camera, model: str,
                     config: LandmarkEKFConfig) -> EKFResult:
    """EKF update of M landmarks against row-aligned measurements.

    positions [M, 3] and covariances [M, 3, 3] in the local-map frame;
    measurements [M, 4]; valid [M] marks rows that observed the landmark.
    """
    if model != "stereo":
        raise NotImplementedError(f"EKF measurement model {model!r} is not ported yet")
    R = T_world_in_sensor[:3, :3]
    t = T_world_in_sensor[:3, 3]
    # predict: into the sensor frame (zero process noise)
    p_s = positions @ R.T + t
    P_s = R @ covariances @ R.T
    r_noise = config.measurement_noise_px2

    def sweep(x_lin):
        h, H = _measurement_model_stereo(x_lin, cam)
        innov0 = measurements - h - _matvec(H, p_s - x_lin)
        dx = torch.zeros_like(p_s)
        P = P_s
        for j in range(H.shape[-2]):
            Hj = H[:, j]                               # [M, 3]
            y = innov0[:, j] - (Hj * dx).sum(-1)
            PH = _matvec(P, Hj)                        # [M, 3]
            s = r_noise + (Hj * PH).sum(-1)
            k = PH / s[:, None]
            dx = dx + k * y[:, None]
            P = P - k[:, :, None] * PH[:, None, :]
        return dx, P

    dx1, _ = sweep(p_s)
    dx, P_s_new = sweep(p_s + dx1)
    p_s_new = p_s + dx
    jump2 = ((p_s_new - p_s) ** 2).sum(-1)
    ok = (
        valid
        & (p_s_new[:, 2] > 0.0)
        & ((P_s_new * P_s_new).sum((-1, -2)) <= config.maximum_covariance_norm_squared)
        & (jump2 <= config.maximum_distance_geometry_m2)
        & torch.isfinite(p_s_new).all(-1)
    )
    # back into the map frame, with the covariance floor
    p_w_new = (p_s_new - t) @ R
    P_w_new = R.T @ P_s_new @ R
    floor = config.minimum_state_element_covariance
    diag = torch.diagonal(P_w_new, dim1=-2, dim2=-1)
    P_w_new = P_w_new + torch.diag_embed(torch.clamp_min(floor - diag, 0.0))
    return EKFResult(
        position=torch.where(ok[:, None], p_w_new, positions),
        covariance=torch.where(ok[:, None, None], P_w_new, covariances),
        accepted=ok,
    )


def initial_covariance(depth: torch.Tensor, cam: Camera,
                       base_px2: float = 1.0) -> torch.Tensor:
    """Depth-scaled diagonal initial covariance [M, 3, 3] for new landmarks."""
    sigma_uv = base_px2 ** 0.5 * depth / cam.fx
    sigma_z = base_px2 ** 0.5 * depth * depth / max(cam.baseline_px, 1.0)
    var = torch.stack([sigma_uv ** 2, sigma_uv ** 2, sigma_z ** 2], dim=-1)
    return torch.diag_embed(torch.clamp_min(var, 0.01))
