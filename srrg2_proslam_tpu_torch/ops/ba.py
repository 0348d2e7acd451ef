"""Local bundle adjustment: batched Gauss-Newton over keyframes and landmarks.

Port of srrg2_proslam_tpu/ops/ba.py.  A fixed-capacity problem (keyframe
poses, landmarks, observation -> keyframe / landmark indices, stereo
(uL, vL, uR) or RGB-D (u, v, depth) rows, a validity mask) is refined by
``iterations`` GN steps, each one residual/Jacobian evaluation over every
observation and block reductions by ``index_add``:

  * ``structure_only`` (the default): keyframe poses frozen, each
    landmark's damped 3x3 block solved on its own;
  * joint: the Schur complement of the landmark blocks, per-(landmark,
    keyframe) coupling blocks W [L, P, 6, 3], a dense [6P, 6P] camera
    solve with a gauge anchor on keyframe 0, and landmark
    back-substitution.

The saturated robust kernel weights each observation.  Nothing is read
back to the host.

On a mesh (``mesh``: parallel/spmd.py) the observation arrays are sharded:
each rank reduces its observations into (Hll, bl, Hpp, bp, W) and the
robust chi, a SUM all-reduce combines them, and poses, points and the
reduced camera solve stay replicated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils import config as cfg
from . import se3
from .pinhole import Camera


@cfg.register
@dataclass(frozen=True)
class BAConfig:
    iterations: int = 5
    damping: float = 1e-3            # Levenberg diagonal damping
    chi_threshold: float = 25.0      # saturated robust kernel
    anchor_weight: float = 1e6       # gauge prior on keyframe 0
    depth_weight: float = 1.0        # extra weight on the third residual row
    # refine landmarks with the keyframe poses frozen (no camera solve)
    structure_only: bool = True


class BAProblem(NamedTuple):
    """poses [P, 4, 4] world_from_keyframe; points [L, 3] world frame;
    obs_kf, obs_lm [O] indices; obs_z [O, 3]; obs_valid [O]."""

    poses: torch.Tensor
    pose_valid: torch.Tensor
    points: torch.Tensor
    point_valid: torch.Tensor
    obs_kf: torch.Tensor
    obs_lm: torch.Tensor
    obs_z: torch.Tensor
    obs_valid: torch.Tensor


def empty_problem(num_poses: int, num_points: int, num_obs: int,
                  device=torch.device("cuda")) -> BAProblem:
    return BAProblem(
        poses=torch.eye(4, dtype=torch.float32, device=device).repeat(num_poses, 1, 1),
        pose_valid=torch.zeros((num_poses,), dtype=torch.bool, device=device),
        points=torch.zeros((num_points, 3), dtype=torch.float32, device=device),
        point_valid=torch.zeros((num_points,), dtype=torch.bool, device=device),
        obs_kf=torch.zeros((num_obs,), dtype=torch.int32, device=device),
        obs_lm=torch.zeros((num_obs,), dtype=torch.int32, device=device),
        obs_z=torch.zeros((num_obs, 3), dtype=torch.float32, device=device),
        obs_valid=torch.zeros((num_obs,), dtype=torch.bool, device=device),
    )


def _observation_terms(poses, points, problem: BAProblem, cam: Camera,
                       model: str, chi_threshold: float, depth_weight: float):
    """Residuals [O, 3], pose Jacobians [O, 3, 6], point Jacobians
    [O, 3, 3], robust weights [O] and the robust chi sum.  The pose
    perturbation is T_cw <- exp(dx) T_cw with T_cw = poses[kf]^-1."""
    kf, lm = problem.obs_kf.long(), problem.obs_lm.long()
    T_cw = se3.inverse(poses)[kf]                       # [O, 4, 4]
    p_w = points[lm]
    R = T_cw[:, :3, :3]
    p_c = torch.einsum("oij,oj->oi", R, p_w) + T_cw[:, :3, 3]
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    iz = 1.0 / torch.clamp_min(z, 1e-3)
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    zero = torch.zeros_like(x)
    sw = depth_weight ** 0.5
    if model == "stereo":
        third = u - cam.baseline_px * iz
        row3 = torch.stack([cam.fx * iz, zero, (-cam.fx * x + cam.baseline_px) * iz2], -1)
    else:
        third = z
        row3 = torch.stack([zero, zero, torch.ones_like(x)], -1)
    z_obs = problem.obs_z
    r = torch.stack([u, v, sw * third], -1) - torch.stack(
        [z_obs[:, 0], z_obs[:, 1], z_obs[:, 2] * sw], -1)
    Jh = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        sw * row3,
    ], dim=-2)                                          # [O, 3, 3]
    eye = torch.eye(3, dtype=torch.float32, device=p_c.device).expand(Jh.shape)
    Jp = Jh @ torch.cat([eye, -se3.skew(p_c)], dim=-1)  # [O, 3, 6]
    Jl = Jh @ R                                         # [O, 3, 3]
    mask = problem.obs_valid & (z > cam.range_min)
    chi = (r * r).sum(-1)
    kw = torch.clamp_max(chi_threshold / torch.clamp_min(chi, 1e-9), 1.0)
    w = torch.where(mask, kw, 0.0)
    chi_total = torch.where(mask, torch.clamp_max(chi, chi_threshold), 0.0).sum()
    return r, Jp, Jl, w, chi_total


def _safe_inv3(H):
    """Batched 3x3 inverse; a block that cannot be inverted gives NaN."""
    inv, info = torch.linalg.inv_ex(H)
    return torch.where((info == 0)[:, None, None], inv, float("nan"))


def _gn_iteration(poses, points, problem: BAProblem, cam: Camera, model: str,
                  config: BAConfig, mesh=None):
    P, L = poses.shape[0], points.shape[0]
    dev = points.device
    r, Jp, Jl, w, chi_total = _observation_terms(
        poses, points, problem, cam, model, config.chi_threshold, config.depth_weight)
    kf, lm = problem.obs_kf.long(), problem.obs_lm.long()
    f32 = dict(dtype=torch.float32, device=dev)
    reduce = (lambda t: t) if mesh is None else (lambda t: mesh.all_sum(t, "ba"))
    chi_total = reduce(chi_total)

    Hll = reduce(torch.zeros((L, 3, 3), **f32).index_add_(
        0, lm, torch.einsum("odi,odj,o->oij", Jl, Jl, w)))
    bl = reduce(torch.zeros((L, 3), **f32).index_add_(
        0, lm, torch.einsum("odi,od,o->oi", Jl, r, w)))
    observed = reduce(torch.zeros((L,), **f32).index_add_(
        0, lm, (w > 0).to(torch.float32))) > 0
    eye3 = torch.eye(3, **f32)
    Hll_inv = _safe_inv3(Hll + (config.damping + 1e-6) * eye3)

    if config.structure_only:
        dx_l = -torch.einsum("lij,lj->li", Hll_inv, bl)
        dx_l = torch.where(torch.isfinite(dx_l), dx_l, 0.0)
        new_points = torch.where((problem.point_valid & observed)[:, None],
                                 points + dx_l, points)
        return poses, new_points, chi_total

    Hpp = reduce(torch.zeros((P, 6, 6), **f32).index_add_(
        0, kf, torch.einsum("odi,odj,o->oij", Jp, Jp, w)))
    bp = reduce(torch.zeros((P, 6), **f32).index_add_(
        0, kf, torch.einsum("odi,od,o->oi", Jp, r, w)))
    # per-(landmark, keyframe) coupling W[l, p] = sum_o Jp^T Jl
    W = reduce(torch.zeros((L * P, 6, 3), **f32).index_add_(
        0, lm * P + kf, torch.einsum("odi,odj,o->oij", Jp, Jl, w))).reshape(L, P, 6, 3)

    # Schur complement of the camera system (cross-keyframe fill-in included)
    Y = torch.einsum("lpij,ljk->lpik", W, Hll_inv)          # [L, P, 6, 3]
    S_red = torch.einsum("lpik,lqjk->piqj", Y, W)           # [P, 6, P, 6]
    b_red = bp - torch.einsum("lpik,lk->pi", Y, bl)
    S = -S_red
    idx = torch.arange(P, device=dev)
    # gauge anchor + damping + SPD floor for empty keyframes
    prior = torch.where(idx == 0, config.anchor_weight,
                        torch.where(problem.pose_valid, config.damping, 1.0))
    S[idx, :, idx, :] += Hpp + prior[:, None, None] * torch.eye(6, **f32)
    sol, info = torch.linalg.solve_ex(S.reshape(6 * P, 6 * P), b_red.reshape(-1))
    dx_p = -sol
    good = (info == 0) & torch.isfinite(dx_p).all()
    dx_p = torch.where(good, dx_p, 0.0).reshape(P, 6)

    # landmark back-substitution: dx_l = -Hll^-1 (bl + W^T dx_p)
    rhs = bl + torch.einsum("lpij,pi->lj", W, dx_p)
    dx_l = -torch.einsum("lij,lj->li", Hll_inv, rhs)
    dx_l = torch.where(torch.isfinite(dx_l), dx_l, 0.0)
    # the perturbation was defined on T_cw = T_wk^-1: T_wk <- T_wk exp(-dx)
    new_poses = poses @ se3.exp(-dx_p)
    new_points = torch.where((problem.point_valid & observed)[:, None],
                             points + dx_l, points)
    return new_poses, new_points, chi_total


def optimize(problem: BAProblem, cam: Camera, model: str = "stereo",
             config: BAConfig = BAConfig(), mesh=None):
    """``config.iterations`` GN steps; returns (problem', chi of the last
    step's linearisation point)."""
    poses, points = problem.poses, problem.points
    chi = torch.zeros((), dtype=torch.float32, device=points.device)
    for _ in range(config.iterations):
        poses, points, chi = _gn_iteration(poses, points, problem, cam, model, config, mesh)
    return problem._replace(poses=poses, points=points), chi
