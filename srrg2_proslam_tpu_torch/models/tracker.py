"""Frame-to-map tracker: clip -> align -> merge, one step per frame.

Port of srrg2_proslam_tpu/models/tracker.py for the stereo model with the
EKF landmark estimator:

  * scene clipping is an in-view mask over the whole arena;
  * alignment runs ``rounds`` re-association rounds, each a projective
    match followed by one GN burst (kernel K2 on a CUDA tensor);
  * the merge updates matched landmarks with the batched EKF and inserts
    ranked, binned unmatched measurements into free arena slots;
  * the pose and the constant-velocity model update last.

Other models and estimators raise NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import se3
from ..ops.ekf import LandmarkEKFConfig, ekf_update_batch, initial_covariance
from ..ops.landmark_estimators import SmootherConfig, WeightedMeanConfig
from ..ops.matching import ProjectiveMatcherConfig, match_projective
from ..ops.pinhole import Camera, project
from ..ops.triangulation import triangulate_rectified
from . import landmarks as lm
from .landmarks import LandmarkArena


@dataclass(frozen=True)
class MergerConfig:
    target_number_of_merges: int = 100
    maximum_distance_appearance: float = 100.0
    enable_binning: bool = True
    bin_size_px: int = 25
    max_additions: int = 512


@dataclass(frozen=True)
class TrackerConfig:
    """Same fields and defaults as the JAX package's TrackerConfig.

    ``gn_pallas`` and ``gn_unroll`` are kept for that parity and have no
    effect: a CUDA tensor always takes the GN burst kernel (K2), a CPU
    tensor its plain version, and there is no compiled loop to unroll.
    """

    matcher: ProjectiveMatcherConfig = field(default_factory=ProjectiveMatcherConfig)
    merger: MergerConfig = field(default_factory=MergerConfig)
    ekf: LandmarkEKFConfig = field(default_factory=LandmarkEKFConfig)
    weighted_mean: WeightedMeanConfig = field(default_factory=WeightedMeanConfig)
    smoother: SmootherConfig = field(default_factory=SmootherConfig)
    landmark_estimator: str = "ekf"
    rounds: int = 3
    gn_iterations: int = 5
    gn_epsilon: float = 0.0
    gn_unroll: bool = False
    gn_pallas: bool = True
    damping: float = 1e-6
    min_num_inliers: int = 6
    chi_threshold: float = 25.0
    minimum_disparity_px: float = 1.0
    T_robot_sensor: tuple = (1.0, 0.0, 0.0, 0.0,
                             0.0, 1.0, 0.0, 0.0,
                             0.0, 0.0, 1.0, 0.0,
                             0.0, 0.0, 0.0, 1.0)
    motion_prior_translation_info: float = 0.0
    motion_prior_rotation_info: float = 0.0
    stereo_inverse_depth_weighting: bool = False


class TrackerState(NamedTuple):
    arena: LandmarkArena
    T_lm_robot: torch.Tensor    # robot pose in the local-map frame (4x4)
    velocity: torch.Tensor      # constant-velocity twist [6]

    def to(self, device) -> "TrackerState":
        return TrackerState(self.arena.to(device), self.T_lm_robot.to(device),
                            self.velocity.to(device))


class TrackStats(NamedTuple):
    num_measurements: torch.Tensor
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    chi_per_inlier: torch.Tensor
    num_merges: torch.Tensor
    num_additions: torch.Tensor
    matcher_stage: torch.Tensor
    trans_in_map: torch.Tensor
    rot_in_map: torch.Tensor
    match_idx: torch.Tensor     # [N] int32 landmark index per measurement (-1)
    match_mask: torch.Tensor    # [N] bool
    # [num_inliers, trans_in_map, rot_in_map, num_matches, num_merges,
    #  num_additions, chi_per_inlier, matcher_stage, T_lm_robot[:3,:].ravel()]
    host_packet: torch.Tensor


def initial_state(capacity: int, device=torch.device("cuda")) -> TrackerState:
    return TrackerState(
        arena=lm.empty_arena(capacity, device),
        T_lm_robot=se3.identity(device),
        velocity=torch.zeros(6, dtype=torch.float32, device=device),
    )


_STATE_KEYS = ("pos", "cov", "desc", "num_updates", "valid",
               "T_lm_robot", "velocity")


def state_to_numpy(state: TrackerState) -> dict:
    """TrackerState -> dict of numpy arrays (arena fields, pose, velocity)."""
    arrays = dict(state.arena._asdict(), T_lm_robot=state.T_lm_robot,
                  velocity=state.velocity)
    return {k: arrays[k].detach().cpu().numpy() for k in _STATE_KEYS}


def state_from_numpy(d: dict, device=torch.device("cuda")) -> TrackerState:
    """Inverse of :func:`state_to_numpy` (same keys as the JAX state's leaves)."""
    t = {k: torch.as_tensor(np.asarray(d[k]), device=device) for k in _STATE_KEYS}
    arena = LandmarkArena(
        pos=t["pos"].to(torch.float32), cov=t["cov"].to(torch.float32),
        desc=t["desc"].to(torch.int8), num_updates=t["num_updates"].to(torch.int32),
        valid=t["valid"].to(torch.bool))
    return TrackerState(arena, t["T_lm_robot"].to(torch.float32),
                        t["velocity"].to(torch.float32))


def _check_supported(config: TrackerConfig, model: str) -> None:
    if model != "stereo":
        raise NotImplementedError(f"tracker model {model!r} is not ported yet")
    if config.landmark_estimator != "ekf":
        raise NotImplementedError(
            f"landmark estimator {config.landmark_estimator!r} is not ported yet")
    if config.motion_prior_translation_info > 0.0 or config.motion_prior_rotation_info > 0.0:
        raise NotImplementedError("the motion-prior factor is not ported yet")


@lru_cache(maxsize=16)
def _robot_sensor(T_robot_sensor: tuple, device: torch.device):
    """(T_robot_sensor, its inverse) as 4x4 tensors, made once per device."""
    T_rs = torch.tensor(T_robot_sensor, dtype=torch.float32,
                        device=device).reshape(4, 4)
    return T_rs, se3.inverse(T_rs)


def associate(arena: LandmarkArena, X, meas_points, meas_desc, meas_valid,
              cam: Camera, config: TrackerConfig, r: int, weights_all, idw):
    """One re-association round: project the arena with X and match.

    Returns (matches, stage, pts_moving [N,3], weights [N]) — the GN
    burst's inputs for round ``r``.
    """
    n_stages = len(config.matcher.radius_stages)
    pts_sensor = se3.transform_points(X, arena.pos)
    proj_uv, in_view = project(cam, pts_sensor)
    proj_valid = arena.valid & in_view
    # rounds 0..n-2 force the loose-to-tight schedule; the final round picks
    # the tightest good stage adaptively
    is_final = r == config.rounds - 1
    matches, stage = match_projective(
        meas_points[:, :2], meas_desc, meas_valid, proj_uv, arena.desc,
        proj_valid, config.matcher,
        force_stage=-1 if is_final else max(n_stages - 1 - r, 0),
    )
    idx = matches.idx.clamp_min(0).long()
    return matches, stage, arena.pos[idx], weights_all[idx] * idw


def track_step(state: TrackerState, meas_points, meas_desc, meas_valid,
               cam: Camera, config: TrackerConfig, model: str = "stereo"):
    """One tracker step on stereo measurements [N, 4] = (uL vL uR vR).

    Returns (new_state, stats, X_final); ``X_final`` maps local-map points
    into the sensor frame.
    """
    _check_supported(config, model)
    # the GN burst kernel on CUDA tensors; its wrapper computes the plain
    # burst on CPU tensors
    from ..kernels.gn import gn_burst_stereo

    arena = state.arena
    dev = meas_points.device
    T_rs, T_sr = _robot_sensor(tuple(config.T_robot_sensor), dev)
    # constant-velocity prediction
    T_pred = state.T_lm_robot @ se3.exp(state.velocity)
    X_pred = se3.inverse(T_pred @ T_rs)
    X = X_pred

    gn_meas = meas_points[:, :3].contiguous()  # (uL, vL, uR)
    weights_all = 1.0 + torch.log1p(arena.num_updates.to(torch.float32))
    if config.stereo_inverse_depth_weighting:
        disp = meas_points[:, 0] - meas_points[:, 2]
        mean_disp = torch.where(meas_valid, disp, 0.0).sum() / torch.clamp_min(
            meas_valid.sum(), 1)
        idw = 0.01 + disp / torch.clamp_min(mean_disp, 1e-3)
    else:
        idw = torch.ones((meas_points.shape[0],), dtype=torch.float32, device=dev)

    # ---- alignment: re-association rounds, one GN burst each ---------------
    for r in range(config.rounds):
        matches, stage, pts_moving, weights = associate(
            arena, X, meas_points, meas_desc, meas_valid, cam, config, r,
            weights_all, idw)
        X, stats = gn_burst_stereo(
            X.contiguous(), pts_moving, gn_meas, weights, matches.mask, cam,
            iterations=config.gn_iterations, damping=config.damping,
            min_inliers=config.min_num_inliers, epsilon=config.gn_epsilon,
            chi_threshold=config.chi_threshold)

    # ---- merge: EKF update of matched landmarks ----------------------------
    M = arena.capacity
    # measurement rows scattered to their matched landmark slots; unmatched
    # rows all land in the sink row M
    idx_safe = torch.where(matches.mask, matches.idx.long(), M)

    def by_landmark(fill, values):
        out = torch.full((M + 1,) + values.shape[1:], fill, dtype=values.dtype,
                         device=dev)
        out[idx_safe] = values
        return out[:M]

    z_by_lm = by_landmark(0.0, meas_points)
    desc_by_lm = by_landmark(0, meas_desc)
    matched_lm = by_landmark(False, matches.mask)
    dist_by_lm = by_landmark(1e9, matches.distance)
    matched_lm = matched_lm & (dist_by_lm <= config.merger.maximum_distance_appearance)

    ekf_out = ekf_update_batch(arena.pos, arena.cov, z_by_lm, matched_lm, X, cam,
                               "stereo", config.ekf)
    accepted = ekf_out.accepted
    num_merges = accepted.sum()
    arena = arena._replace(
        pos=ekf_out.position,
        cov=ekf_out.covariance,
        desc=torch.where(matched_lm[:, None], desc_by_lm, arena.desc),
        num_updates=arena.num_updates + accepted.to(torch.int32),
    )

    # ---- merge: ranked binned insertion of unmatched measurements ----------
    pts_sensor_new, tri_ok = triangulate_rectified(
        cam, meas_points, meas_valid, config.minimum_disparity_px)
    pref = meas_points[:, 0] - meas_points[:, 2]  # higher disparity first
    unmatched = meas_valid & ~matches.mask & tri_ok
    allow_adds = num_merges < config.merger.target_number_of_merges

    # one stable preference sort serves both the bin ranking and the
    # insertion order
    N_meas = meas_points.shape[0]
    order = torch.argsort(torch.where(unmatched, -pref, float("inf")),
                          stable=True)
    if config.merger.enable_binning:
        bs = config.merger.bin_size_px
        n_bu = -(-cam.cols // bs)
        n_bv = -(-cam.rows // bs)
        n_bins = n_bu * n_bv

        def bin_id(uv):
            bu = (uv[:, 0].to(torch.int32) // bs).clamp(0, n_bu - 1)
            bv = (uv[:, 1].to(torch.int32) // bs).clamp(0, n_bv - 1)
            return (bv * n_bu + bu).long()

        map_uv, map_in_view = project(cam, se3.transform_points(X, arena.pos))
        map_bins = torch.where(arena.valid & map_in_view, bin_id(map_uv), n_bins)
        occupied = torch.zeros((n_bins + 1,), dtype=torch.bool, device=dev)
        occupied[map_bins] = True
        occupied = occupied[:n_bins]
        cand_bins = bin_id(meas_points[:, :2])
        # best (highest preference) candidate per bin wins; the dense rank is
        # the inverse permutation of ``order``
        rank = torch.empty((N_meas,), dtype=torch.int64, device=dev)
        rank[order] = torch.arange(N_meas, device=dev)
        best_rank = torch.full((n_bins + 1,), 1 << 30, dtype=torch.int64, device=dev)
        best_rank = best_rank.scatter_reduce(
            0, torch.where(unmatched, cand_bins, n_bins),
            torch.where(unmatched, rank, 1 << 30), reduce="amin")[:n_bins]
        cand_safe = cand_bins.clamp(0, n_bins - 1)
        first_in_bin = rank == best_rank[cand_safe]
        unmatched = unmatched & first_in_bin & ~occupied[cand_safe]

    T_sensor_to_lm = se3.inverse(X)
    pts_lm = se3.transform_points(T_sensor_to_lm, pts_sensor_new)
    cov0 = initial_covariance(pts_sensor_new[:, 2], cam)
    R = T_sensor_to_lm[:3, :3]
    cov0_lm = R @ cov0 @ R.T
    want = unmatched[order] & allow_adds
    free_slots = arena.capacity - arena.valid.sum()
    arena = lm.insert(arena, pts_lm[order], cov0_lm[order], meas_desc[order],
                      want, config.merger.max_additions)
    # what insert actually applied: capped by the budget and the free slots
    num_additions = torch.minimum(
        want.sum(), torch.clamp_max(free_slots, config.merger.max_additions))

    # ---- pose & velocity ----------------------------------------------------
    T_lm_robot_new = se3.inverse(X) @ T_sr
    # velocity refreshes only when alignment had enough support
    aligned = stats.num_inliers >= config.min_num_inliers
    vel_new = se3.log(se3.inverse(state.T_lm_robot) @ T_lm_robot_new)
    new_state = TrackerState(
        arena=arena,
        T_lm_robot=torch.where(aligned, T_lm_robot_new, T_pred),
        velocity=torch.where(aligned, vel_new, state.velocity),
    )
    T_final = new_state.T_lm_robot
    num_inliers = stats.num_inliers
    chi_per_inlier = stats.chi_total / torch.clamp_min(num_inliers, 1)
    trans_in_map = torch.linalg.vector_norm(T_final[:3, 3])
    rot_in_map = torch.linalg.vector_norm(se3.log_so3(T_final[:3, :3]))
    host_packet = torch.cat([
        torch.stack([
            num_inliers.to(torch.float32), trans_in_map, rot_in_map,
            matches.count.to(torch.float32), num_merges.to(torch.float32),
            num_additions.to(torch.float32), chi_per_inlier,
            stage.to(torch.float32),
        ]),
        T_final[:3, :].reshape(12),
    ])
    out_stats = TrackStats(
        num_measurements=meas_valid.sum(),
        num_matches=matches.count,
        num_inliers=num_inliers,
        chi_per_inlier=chi_per_inlier,
        num_merges=num_merges,
        num_additions=num_additions,
        matcher_stage=stage,
        trans_in_map=trans_in_map,
        rot_in_map=rot_in_map,
        match_idx=matches.idx,
        match_mask=matches.mask,
        host_packet=host_packet,
    )
    return new_state, out_stats, torch.where(aligned, X, X_pred)
