"""Landmark estimators: weighted running mean and pose-based GN smoother.

Port of srrg2_proslam_tpu/ops/landmark_estimators.py (the EKF family is
ops/ekf.py).  The JAX package vmaps one landmark's update over the arena;
here the arena is a batch dimension [M, ...]:

  * ``weighted_mean_update_batch``: running mean weighted by the update
    count, with a geometric-jump gate (elementwise);
  * ``smoother_update_batch``: structure-only Gauss-Newton of every
    landmark over the K slots of its measurement ring buffer
    (reprojection u, v plus the depth row, weighted ``depth_weight``,
    saturated kernel), ``iterations`` steps of batched 3x3 solves with no
    host read, a mean fallback below the minimum measurement count and
    inlier-count acceptance.

The ring buffer is written by one-hot arithmetic (``buf * keep + one_hot *
new``), as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils import config as cfg
from .pinhole import Camera


@cfg.register
@dataclass(frozen=True)
class WeightedMeanConfig:
    maximum_distance_geometry_m2: float = 25.0


@cfg.register
@dataclass(frozen=True)
class SmootherConfig:
    maximum_reprojection_error_px2: float = 100.0
    minimum_measurements: int = 3
    iterations: int = 10
    depth_weight: float = 10.0
    maximum_distance_geometry_m2: float = 25.0


class WeightedMeanResult(NamedTuple):
    position: torch.Tensor   # [M, 3]
    accepted: torch.Tensor   # [M] bool


def weighted_mean_update_batch(positions, num_updates, p_world_meas, valid,
                               config: WeightedMeanConfig) -> WeightedMeanResult:
    """new = ((n + 1) old + meas) / (n + 2), refused when the state would
    jump more than the geometric gate.  positions, p_world_meas [M, 3];
    num_updates [M] int32; valid [M] bool."""
    w = num_updates.to(torch.float32) + 1.0
    proposed = (w[:, None] * positions + p_world_meas) / (w[:, None] + 1.0)
    jump2 = ((proposed - positions) ** 2).sum(-1)
    ok = valid & (jump2 <= config.maximum_distance_geometry_m2)
    return WeightedMeanResult(position=torch.where(ok[:, None], proposed, positions),
                              accepted=ok)


class MeasurementBuffer(NamedTuple):
    """Per-landmark ring buffers of K camera measurements: slot k of
    landmark m holds the image point, the camera-frame point and the
    world->camera transform of that observation."""

    point_in_image: torch.Tensor   # [M, K, 2] (u, v)
    point_in_camera: torch.Tensor  # [M, K, 3] sensor frame
    T_world_to_cam: torch.Tensor   # [M, K, 4, 4]
    count: torch.Tensor            # [M] int32 observations so far (ring index)

    @property
    def capacity(self) -> int:
        return self.point_in_image.shape[1]

    def to(self, device) -> "MeasurementBuffer":
        return MeasurementBuffer(*(t.to(device) for t in self))


def empty_measurement_buffer(num_landmarks: int, capacity: int = 8,
                             device=torch.device("cuda")) -> MeasurementBuffer:
    """Empty buffers; every T_world_to_cam slot a materialised identity."""
    return MeasurementBuffer(
        point_in_image=torch.zeros((num_landmarks, capacity, 2), dtype=torch.float32,
                                   device=device),
        point_in_camera=torch.zeros((num_landmarks, capacity, 3), dtype=torch.float32,
                                    device=device),
        T_world_to_cam=torch.eye(4, dtype=torch.float32, device=device).repeat(
            num_landmarks, capacity, 1, 1),
        count=torch.zeros((num_landmarks,), dtype=torch.int32, device=device),
    )


def add_measurements(buf: MeasurementBuffer, uv, p_cam, T_world_to_cam,
                     observed) -> MeasurementBuffer:
    """Ring-buffer insert of this frame's observation for each observed
    landmark: uv [M, 2], p_cam [M, 3], the frame's T_world_to_cam [4, 4],
    observed [M] bool."""
    K = buf.capacity
    slot = (buf.count % K).long()
    one_hot = torch.nn.functional.one_hot(slot, K).to(torch.float32) \
        * observed[:, None].to(torch.float32)
    keep = 1.0 - one_hot
    return MeasurementBuffer(
        point_in_image=buf.point_in_image * keep[..., None]
        + one_hot[..., None] * uv[:, None, :],
        point_in_camera=buf.point_in_camera * keep[..., None]
        + one_hot[..., None] * p_cam[:, None, :],
        T_world_to_cam=buf.T_world_to_cam * keep[..., None, None]
        + one_hot[..., None, None] * T_world_to_cam[None, None],
        count=buf.count + observed.to(torch.int32),
    )


class SmootherResult(NamedTuple):
    position: torch.Tensor     # [M, 3] world frame
    accepted: torch.Tensor     # [M] bool
    num_inliers: torch.Tensor  # [M] int32


def _mean_world_coordinates(buf_cam, buf_Twc, slot_valid):
    """Mean over the valid slots of R^T (p_cam - t): [M, K, ...] -> [M, 3]."""
    R = buf_Twc[..., :3, :3]
    t = buf_Twc[..., :3, 3]
    p_w = torch.einsum("mkji,mkj->mki", R, buf_cam - t)
    w = slot_valid.to(torch.float32)
    return (p_w * w[..., None]).sum(-2) / torch.clamp_min(w.sum(-1), 1.0)[..., None]


def _smooth_single(p_world, buf_img, buf_cam, buf_Twc, count, num_updates, lm_valid,
                   cam: Camera, config: SmootherConfig):
    """Structure-only GN of M landmarks over their K slots (the JAX
    package's per-landmark function, with the arena as a batch dimension):
    p_world [M, 3], buf_* [M, K, ...], count, num_updates, lm_valid [M]."""
    M, K = buf_img.shape[:2]
    dev = p_world.device
    slot_valid = torch.arange(K, device=dev)[None, :] < count[:, None]
    n_meas = slot_valid.sum(-1)
    omega = torch.ones((3,), dtype=torch.float32, device=dev)
    omega[2].fill_(config.depth_weight)     # a fill: a Python scalar write syncs
    R = buf_Twc[..., :3, :3]                                 # [M, K, 3, 3]
    t = buf_Twc[..., :3, 3]
    thr = config.maximum_reprojection_error_px2
    eye = torch.eye(3, dtype=torch.float32, device=dev)

    x = p_world
    inliers = torch.zeros((M,), dtype=torch.int32, device=dev)
    for _ in range(config.iterations):
        p_c = torch.einsum("mkij,mj->mki", R, x) + t
        z = p_c[..., 2]
        iz = 1.0 / torch.clamp_min(z, 1e-3)
        u = cam.fx * p_c[..., 0] * iz + cam.cx
        v = cam.fy * p_c[..., 1] * iz + cam.cy
        r = torch.stack([u - buf_img[..., 0], v - buf_img[..., 1], z - buf_cam[..., 2]], -1)
        ok = slot_valid & (z > 0.0)
        chi = (r * r * omega).sum(-1)
        kw = torch.clamp_max(thr / torch.clamp_min(chi, 1e-9), 1.0)
        w = torch.where(ok, kw, 0.0)
        iz2 = iz * iz
        zero = torch.zeros_like(iz)
        Jh = torch.stack([
            torch.stack([cam.fx * iz, zero, -cam.fx * p_c[..., 0] * iz2], -1),
            torch.stack([zero, cam.fy * iz, -cam.fy * p_c[..., 1] * iz2], -1),
            torch.stack([zero, zero, torch.ones_like(iz)], -1),
        ], dim=-2)                                           # [M, K, 3, 3]
        J = Jh @ R
        Wo = omega * w[..., None]                            # [M, K, 3]
        H = torch.einsum("mkdi,mkd,mkdj->mij", J, Wo, J)
        b = torch.einsum("mkdi,mkd,mkd->mi", J, Wo, r)
        sol, info = torch.linalg.solve_ex(H + 1e-6 * eye, b)
        dx = -sol
        dx = torch.where(((info == 0) & torch.isfinite(dx).all(-1))[:, None], dx, 0.0)
        inliers = (ok & (chi <= thr)).sum(-1).to(torch.int32)
        x = x + dx

    mean_w = _mean_world_coordinates(buf_cam, buf_Twc, slot_valid)
    use_mean = n_meas < config.minimum_measurements
    accept_opt = (~use_mean) & (inliers > num_updates) & torch.isfinite(x).all(-1)
    jump2_mean = ((mean_w - p_world) ** 2).sum(-1)
    accept_mean_update = jump2_mean <= config.maximum_distance_geometry_m2
    candidate = torch.where(accept_opt[:, None], x, mean_w)
    accepted = lm_valid & (n_meas > 0) & (
        accept_opt | (use_mean & accept_mean_update) | ~use_mean)
    position = torch.where(accepted[:, None], candidate, p_world)
    return position, accepted, inliers


def smoother_update_batch(positions, buf: MeasurementBuffer, num_updates, lm_valid,
                          cam: Camera, config: SmootherConfig) -> SmootherResult:
    """Pose-based smoother over the whole arena: positions [M, 3] world
    frame, num_updates [M] int32, lm_valid [M] bool."""
    pos, ok, inl = _smooth_single(positions, buf.point_in_image, buf.point_in_camera,
                                  buf.T_world_to_cam, buf.count, num_updates, lm_valid,
                                  cam, config)
    return SmootherResult(position=pos, accepted=ok, num_inliers=inl)
