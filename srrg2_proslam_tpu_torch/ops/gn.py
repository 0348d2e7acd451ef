"""Gauss-Newton pose estimation: the rectified-stereo, projective-depth and
point-to-point factors.

Port of srrg2_proslam_tpu/ops/gn.py.  The
estimate X maps moving-frame points into the fixed (sensor) frame and is
updated by left multiplication X <- exp(dx) X, dx = [v, w]; the Jacobian of
(exp(dx) X p) at dx = 0 is [I | -skew(X p)].  ``gn_iterate`` over
``stereo_projective_system`` is the plain version of the GN burst kernel
(kernels/gn.py).  ``gn_iterate(..., unroll=True)`` runs the same loop
with a sticky live flag and no host read (the tracker's generic route:
RGB-D and the motion prior).  ``gn_iterate_batch`` runs K independent estimates at
once without reading anything back to the host (loop-closure validation).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

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


def robust_clamp(chi: torch.Tensor, chi_threshold: float) -> torch.Tensor:
    """Clamp kernel: weight 0 beyond the threshold (RobustifierClamp, chi=3)."""
    return (chi <= chi_threshold).to(torch.float32)


def _reduce_system(J, r, weights, mask, chi_threshold,
                   kernel: Callable = robust_saturate):
    """(H, b, stats) with per-term robust reweighting.

    J: [..., C, D, 6], r: [..., C, D], weights: [..., C], mask: [..., C]
    bool; leading dimensions batch independent systems.
    """
    chi = torch.sum(r * r, dim=-1) * weights
    kw = kernel(chi, chi_threshold)
    w = torch.where(mask, weights * kw, 0.0)
    H = torch.einsum("...cdi,...cdj,...c->...ij", J, J, w)
    b = torch.einsum("...cdi,...cd,...c->...i", J, r, w)
    inlier = mask & (chi <= chi_threshold)
    stats = GNStats(
        chi_total=torch.where(mask, torch.clamp_max(chi, chi_threshold), 0.0).sum(-1),
        num_inliers=inlier.sum(-1).to(torch.int32),
        num_terms=mask.sum(-1).to(torch.int32),
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


def projective_depth_system(X, pts_moving, meas_uvd, weights, mask,
                            cam: Camera, chi_threshold: float = 25.0,
                            depth_weight: float = 10.0):
    """Normal equations of the pinhole + depth (RGB-D) residual
    r = (fx x/z + cx, fy y/z + cy, sqrt(w_d) z) - (u, v, sqrt(w_d) d)."""
    p = se3.transform_points(X, pts_moving)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    iz = 1.0 / torch.clamp_min(z, 1e-3)
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    sw = depth_weight ** 0.5
    r = torch.stack([u, v, sw * z], dim=-1) - torch.stack(
        [meas_uvd[:, 0], meas_uvd[:, 1], meas_uvd[:, 2] * sw], dim=-1)
    zero = torch.zeros_like(x)
    Jp = torch.stack(
        [
            torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
            torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
            torch.stack([zero, zero, torch.full_like(x, sw)], -1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(Jp.shape)
    J = Jp @ torch.cat([eye, -se3.skew(p)], dim=-1)  # [C, 3, 6]
    mask = mask & (z > cam.range_min)
    return _reduce_system(J, r, weights, mask, chi_threshold)


def point3_system(X, pts_moving, pts_fixed, weights, mask,
                  chi_threshold: float = 3.0, kernel: Callable = robust_clamp):
    """Normal equations of the point-to-point residual r = X p - q (loop
    closures).  X [..., 4, 4]; pts_moving, pts_fixed [..., C, 3]; weights,
    mask [..., C]; leading dimensions batch independent systems."""
    p = se3.transform_points(X, pts_moving)
    r = p - pts_fixed
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape + (3,))
    J = torch.cat([eye, -se3.skew(p)], dim=-1)
    return _reduce_system(J, r, weights, mask, chi_threshold, kernel)


def gn_step(X, H, b, damping: float = 1e-6):
    """One damped GN update X <- exp(-(H + damping I)^-1 b) X."""
    return gn_step_dx(X, H, b, damping)[0]


def gn_step_dx(X, H, b, damping: float = 1e-6):
    """One damped step: (exp(dx) X, dx) with dx = -(H + damping I)^-1 b.

    Batched over leading dimensions; a solve that fails or gives a
    non-finite dx yields dx = 0 for that system.
    """
    Hd = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    sol, info = torch.linalg.solve_ex(Hd, b)
    dx = -sol
    good = (info == 0) & torch.isfinite(dx).all(-1)
    dx = torch.where(good[..., None], dx, 0.0)
    return se3.exp(dx) @ X, dx


def gn_iterate(system_fn, X0, iterations: int, damping: float = 1e-6,
               min_inliers: int = 6, epsilon: float = 0.0, unroll: bool = False):
    """Up to ``iterations`` GN steps of a 6-DoF system.

    A step applies only when at least ``min_inliers`` terms are active; the
    loop ends once the applied twist norm is not above ``epsilon`` (a
    refused step counts as norm 0).  Returns (X, stats of the last step).

    ``unroll`` chooses the scheme, not the result (select for select the
    same, as in the JAX package): False reads the stop flag back to the
    host each iteration and leaves the loop; True runs every iteration with
    a sticky live flag, so a stopped estimate and its stats stay frozen,
    and reads nothing back.
    """
    X = X0
    stats = GNStats(torch.zeros((), dtype=torch.float32, device=X0.device),
                    torch.zeros((), dtype=torch.int32, device=X0.device),
                    torch.zeros((), dtype=torch.int32, device=X0.device))
    if unroll:
        live = torch.ones((), dtype=torch.bool, device=X0.device)
        for _ in range(iterations):
            H, b, stats_i = system_fn(X)
            X_new, dx = gn_step_dx(X, H, b, damping)
            ok = stats_i.num_terms >= min_inliers
            X = torch.where(live & ok, X_new, X)
            stats = GNStats(*(torch.where(live, a, s) for a, s in zip(stats_i, stats)))
            dx_norm = torch.where(ok, torch.linalg.vector_norm(dx), 0.0)
            live = live & (dx_norm > epsilon)
        return X, stats
    for _ in range(iterations):
        H, b, stats = system_fn(X)
        X_new, dx = gn_step_dx(X, H, b, damping)
        ok = stats.num_terms >= min_inliers
        X = torch.where(ok, X_new, X)
        dx_norm = torch.where(ok, torch.linalg.vector_norm(dx), 0.0)
        if not bool(dx_norm > epsilon):
            break
    return X, stats


def gn_iterate_batch(system_fn, X0, iterations: int, damping: float = 1e-6,
                     min_inliers: int = 6, epsilon: float = 0.0):
    """``gn_iterate`` over K independent estimates X0 [K, 4, 4], with no host
    read: all ``iterations`` run, and a sticky per-estimate live flag
    (dx_norm > epsilon, refused step = 0) keeps an estimate and its stats
    frozen from the iteration after it stopped.  Select for select this is
    the per-estimate early-exit loop (the JAX package's vmapped
    ``while_loop``, ``ops/gn.py:250-269``).  ``system_fn`` maps X [K, 4, 4]
    to (H [K, 6, 6], b [K, 6], GNStats of [K])."""
    K, dev = X0.shape[0], X0.device
    X = X0
    stats = GNStats(torch.zeros((K,), dtype=torch.float32, device=dev),
                    torch.zeros((K,), dtype=torch.int32, device=dev),
                    torch.zeros((K,), dtype=torch.int32, device=dev))
    live = torch.ones((K,), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        H, b, stats_i = system_fn(X)
        X_new, dx = gn_step_dx(X, H, b, damping)
        ok = stats_i.num_terms >= min_inliers
        X = torch.where((live & ok)[:, None, None], X_new, X)
        stats = GNStats(*(torch.where(live, a, s) for a, s in zip(stats_i, stats)))
        dx_norm = torch.where(ok, torch.linalg.vector_norm(dx, dim=-1), 0.0)
        live = live & (dx_norm > epsilon)
    return X, stats
