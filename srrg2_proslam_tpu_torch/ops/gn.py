"""Gauss-Newton pose estimation on the rectified-stereo factor.

Port of srrg2_proslam_tpu/ops/gn.py (stereo slice).  The estimate X maps
moving-frame points into the fixed (sensor) frame and is updated by left
multiplication X <- exp(dx) X, dx = [v, w]; the Jacobian of (exp(dx) X p)
at dx = 0 is [I | -skew(X p)].  ``gn_iterate`` over
``stereo_projective_system`` is the plain version of the GN burst kernel
(kernels/gn.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3
from .pinhole import Camera


class GNStats(NamedTuple):
    chi_total: torch.Tensor    # robust chi sum over active terms
    num_inliers: torch.Tensor  # active terms below the robust threshold
    num_terms: torch.Tensor    # active correspondences


def robust_saturate(chi: torch.Tensor, chi_threshold: float) -> torch.Tensor:
    """Saturated kernel weight: w = min(1, threshold/chi)."""
    return torch.clamp_max(chi_threshold / torch.clamp_min(chi, 1e-12), 1.0)


def _reduce_system(J, r, weights, mask, chi_threshold):
    """(H, b, stats) with per-term saturated robust reweighting.

    J: [C, D, 6], r: [C, D], weights: [C], mask: [C] bool.
    """
    chi = torch.sum(r * r, dim=-1) * weights
    kw = robust_saturate(chi, chi_threshold)
    w = torch.where(mask, weights * kw, 0.0)
    H = torch.einsum("cdi,cdj,c->ij", J, J, w)
    b = torch.einsum("cdi,cd,c->i", J, r, w)
    inlier = mask & (chi <= chi_threshold)
    stats = GNStats(
        chi_total=torch.where(mask, torch.clamp_max(chi, chi_threshold), 0.0).sum(),
        num_inliers=inlier.sum().to(torch.int32),
        num_terms=mask.sum().to(torch.int32),
    )
    return H, b, stats


def stereo_projective_system(X, pts_moving, meas_uvu, weights, mask,
                             cam: Camera, chi_threshold: float = 25.0):
    """Normal equations of the rectified-stereo reprojection residual
    r = h(X p) - z, h = (fx x/z + cx, fy y/z + cy, fx x/z + cx - b_px/z)."""
    p = se3.transform_points(X, pts_moving)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    iz = 1.0 / torch.clamp_min(z, 1e-3)
    iz2 = iz * iz
    u_l = cam.fx * x * iz + cam.cx
    v_l = cam.fy * y * iz + cam.cy
    u_r = u_l - cam.baseline_px * iz
    r = torch.stack([u_l, v_l, u_r], dim=-1) - meas_uvu
    zero = torch.zeros_like(x)
    Jp = torch.stack(
        [
            torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
            torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
            torch.stack([cam.fx * iz, zero, (-cam.fx * x + cam.baseline_px) * iz2], -1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(Jp.shape)
    J = Jp @ torch.cat([eye, -se3.skew(p)], dim=-1)  # [C, 3, 6]
    mask = mask & (z > cam.range_min)
    return _reduce_system(J, r, weights, mask, chi_threshold)


def gn_step_dx(X, H, b, damping: float = 1e-6):
    """One damped step: (exp(dx) X, dx) with dx = -(H + damping I)^-1 b.

    A solve that fails or gives a non-finite dx yields dx = 0.
    """
    Hd = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    sol, info = torch.linalg.solve_ex(Hd, b)
    dx = -sol
    good = (info == 0) & torch.isfinite(dx).all()
    dx = torch.where(good, dx, 0.0)
    return se3.exp(dx) @ X, dx


def gn_iterate(system_fn, X0, iterations: int, damping: float = 1e-6,
               min_inliers: int = 6, epsilon: float = 0.0):
    """Up to ``iterations`` GN steps of a 6-DoF system.

    A step applies only when at least ``min_inliers`` terms are active; the
    loop ends once the applied twist norm is not above ``epsilon`` (a
    refused step counts as norm 0).  Returns (X, stats of the last step).
    """
    X = X0
    stats = GNStats(torch.zeros((), dtype=torch.float32, device=X0.device),
                    torch.zeros((), dtype=torch.int32, device=X0.device),
                    torch.zeros((), dtype=torch.int32, device=X0.device))
    for _ in range(iterations):
        H, b, stats = system_fn(X)
        X_new, dx = gn_step_dx(X, H, b, damping)
        ok = stats.num_terms >= min_inliers
        X = torch.where(ok, X_new, X)
        dx_norm = torch.where(ok, torch.linalg.vector_norm(dx), 0.0)
        if not bool(dx_norm > epsilon):
            break
    return X, stats
