"""ATE / RPE trajectory evaluation and regression gates (plain numpy).

A copy of srrg2_proslam_tpu/metrics/trajectory.py: the JAX package cannot
be imported without jax.  Umeyama-style SE3 alignment, per-axis
translation RMSE and rotation RMSE, and the hard-threshold regression
check of the reference's CI gates (benchmark_kitti.cpp:18-21, 80-87).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class TrajectoryError:
    mean_translation_rmse: np.ndarray   # [3] per-axis
    std_translation_rmse: np.ndarray    # [3]
    mean_rotation_deg: float
    std_rotation_deg: float
    ate_rmse: float                     # scalar RMSE of aligned positions


def _rotation_angle_deg(R: np.ndarray) -> float:
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def align_se3(est_xyz: np.ndarray, gt_xyz: np.ndarray,
              est0: np.ndarray = None, gt0: np.ndarray = None) -> np.ndarray:
    """Least-squares SE3 alignment est->gt (rotation + translation, no scale).

    Umeyama on positions is rotationally unconstrained when the trajectory
    is (near-)collinear — e.g. a short straight drive — and then produces an
    arbitrary roll that corrupts rotation errors.  In that degenerate case
    (second singular value << first) fall back to first-pose alignment when
    full poses are provided.
    """
    mu_e = est_xyz.mean(axis=0)
    mu_g = gt_xyz.mean(axis=0)
    H = (est_xyz - mu_e).T @ (gt_xyz - mu_g)
    U, S, Vt = np.linalg.svd(H)
    degenerate = S[0] <= 0 or S[1] / max(S[0], 1e-12) < 1e-3
    if degenerate and est0 is not None and gt0 is not None:
        return gt0 @ np.linalg.inv(est0)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    t = mu_g - R @ mu_e
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def evaluate(est: Sequence[np.ndarray], gt: Sequence[np.ndarray],
             align: bool = True) -> TrajectoryError:
    """Compare pose lists (4x4 world_from_camera). Lengths must match."""
    est = [np.asarray(T, dtype=np.float64) for T in est]
    gt = [np.asarray(T, dtype=np.float64) for T in gt]
    assert len(est) == len(gt) and len(est) > 1
    est_xyz = np.stack([T[:3, 3] for T in est])
    gt_xyz = np.stack([T[:3, 3] for T in gt])
    A = align_se3(est_xyz, gt_xyz, est[0], gt[0]) if align else np.eye(4)
    est_aligned = [A @ T for T in est]
    d = np.stack([e[:3, 3] - g[:3, 3] for e, g in zip(est_aligned, gt)])
    per_axis_rmse = np.sqrt(np.mean(d * d, axis=0))
    per_axis_std = np.std(np.abs(d), axis=0)
    rot_err = np.array([
        _rotation_angle_deg(e[:3, :3].T @ g[:3, :3])
        for e, g in zip(est_aligned, gt)
    ])
    return TrajectoryError(
        mean_translation_rmse=per_axis_rmse,
        std_translation_rmse=per_axis_std,
        mean_rotation_deg=float(rot_err.mean()),
        std_rotation_deg=float(rot_err.std()),
        ate_rmse=float(np.sqrt(np.mean(np.sum(d * d, axis=1)))),
    )


def rpe(est: Sequence[np.ndarray], gt: Sequence[np.ndarray],
        delta: int = 1):
    """Relative pose error over ``delta``-frame increments.

    Returns (translation_errors [K], rotation_errors_deg [K]).
    """
    t_err, r_err = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(np.asarray(est[i])) @ np.asarray(est[i + delta])
        dg = np.linalg.inv(np.asarray(gt[i])) @ np.asarray(gt[i + delta])
        e = np.linalg.inv(dg) @ de
        t_err.append(np.linalg.norm(e[:3, 3]))
        r_err.append(_rotation_angle_deg(e[:3, :3]))
    return np.array(t_err), np.array(r_err)


def is_regression(err: TrajectoryError,
                  max_mean_t: float, max_std_t: float,
                  max_mean_r_deg: float = 3.0,
                  max_std_r_deg: float = 3.0) -> bool:
    """Reference CI gate semantics (benchmark_kitti.cpp:80-87)."""
    return bool(
        np.any(err.mean_translation_rmse > max_mean_t)
        or np.any(err.std_translation_rmse > max_std_t)
        or err.mean_rotation_deg > max_mean_r_deg
        or err.std_rotation_deg > max_std_r_deg
    )
