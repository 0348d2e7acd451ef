"""Frame-to-map tracker: clip -> align -> merge, one step per frame.

Port of srrg2_proslam_tpu/models/tracker.py, for the stereo model
(measurements uL vL uR vR) and the RGB-D model ("rgbd": u v depth):

  * scene clipping is an in-view mask over the whole arena;
  * alignment runs ``rounds`` re-association rounds, each a projective
    match followed by one GN burst;
  * the merge updates matched landmarks with the selected estimator (the
    batched EKF, the weighted mean or the pose-based smoother) and inserts
    ranked, binned unmatched measurements into free arena slots;
  * the pose and the constant-velocity model update last.

The GN route is chosen from the config, where the JAX package chooses it
(its ``use_pallas_gn``): the stereo factor with the motion prior off runs
the burst kernel K2 on a CUDA tensor (kernels/gn.py, its plain version on
a CPU tensor); the RGB-D factor, and any factor with the constant-velocity
motion prior on, run ``ops/gn.py::gn_iterate`` over the (prior-wrapped)
system, as the JAX package does on every backend, with the sticky live
flag (``unroll=True``) so nothing is read back to the host.  K2 has no
prior term, as the TPU kernel has none; this route is not a fallback: K2
raises on bad inputs and never runs its plain version on a CUDA tensor.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import se3
from ..ops.ekf import LandmarkEKFConfig, ekf_update_batch, initial_covariance
from ..ops.gn import gn_iterate, projective_depth_system, stereo_projective_system
from ..ops.landmark_estimators import (
    MeasurementBuffer, SmootherConfig, WeightedMeanConfig, add_measurements,
    empty_measurement_buffer, smoother_update_batch, weighted_mean_update_batch)
from ..ops.matching import ProjectiveMatcherConfig, match_projective
from ..ops.pinhole import Camera, project, unproject
from ..ops.triangulation import triangulate_rectified
from ..utils import config as cfg
from . import landmarks as lm
from .landmarks import LandmarkArena


@cfg.register
@dataclass(frozen=True)
class MergerConfig:
    target_number_of_merges: int = 100
    maximum_distance_appearance: float = 100.0
    enable_binning: bool = True
    bin_size_px: int = 25
    max_additions: int = 512


@cfg.register
@dataclass(frozen=True)
class TrackerConfig:
    """Same fields and defaults as the JAX package's TrackerConfig.

    ``landmark_estimator`` is "ekf", "weighted_mean" or "smoother".
    ``gn_pallas`` and ``gn_unroll`` are kept for that parity and have no
    effect: the stereo factor without the motion prior always takes the GN
    burst (K2 on a CUDA tensor, its plain version on a CPU tensor), and the
    generic route always runs with the sticky flag (select for select the
    early-exit loop).
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
    # per-landmark measurement ring buffers: only with the smoother estimator
    meas_buf: Optional[MeasurementBuffer] = None

    def to(self, device) -> "TrackerState":
        buf = None if self.meas_buf is None else self.meas_buf.to(device)
        return TrackerState(self.arena.to(device), self.T_lm_robot.to(device),
                            self.velocity.to(device), buf)


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


def initial_state(capacity: int, estimator: str = "ekf", smoother_slots: int = 8,
                  device=torch.device("cuda")) -> TrackerState:
    """Empty arena, identity pose, zero velocity; with the smoother
    estimator also empty measurement buffers of ``smoother_slots`` slots."""
    buf = (empty_measurement_buffer(capacity, smoother_slots, device)
           if estimator == "smoother" else None)
    return TrackerState(
        arena=lm.empty_arena(capacity, device),
        T_lm_robot=se3.identity(device),
        velocity=torch.zeros(6, dtype=torch.float32, device=device),
        meas_buf=buf,
    )


_STATE_KEYS = ("pos", "cov", "desc", "num_updates", "valid",
               "T_lm_robot", "velocity")
_BUF_DTYPES = {"point_in_image": torch.float32, "point_in_camera": torch.float32,
               "T_world_to_cam": torch.float32, "count": torch.int32}


def state_to_numpy(state: TrackerState) -> dict:
    """TrackerState -> dict of numpy arrays (arena fields, pose, velocity,
    and the measurement buffers' fields as "meas_buf.<field>" when the
    state has them)."""
    arrays = dict(state.arena._asdict(), T_lm_robot=state.T_lm_robot,
                  velocity=state.velocity)
    out = {k: arrays[k].detach().cpu().numpy() for k in _STATE_KEYS}
    if state.meas_buf is not None:
        for k, v in state.meas_buf._asdict().items():
            out[f"meas_buf.{k}"] = v.detach().cpu().numpy()
    return out


def state_from_numpy(d: dict, device=torch.device("cuda")) -> TrackerState:
    """Inverse of :func:`state_to_numpy` (same keys as the JAX state's leaves)."""
    t = {k: torch.as_tensor(np.asarray(d[k]), device=device) for k in _STATE_KEYS}
    arena = LandmarkArena(
        pos=t["pos"].to(torch.float32), cov=t["cov"].to(torch.float32),
        desc=t["desc"].to(torch.int8), num_updates=t["num_updates"].to(torch.int32),
        valid=t["valid"].to(torch.bool))
    buf = None
    if "meas_buf.count" in d:
        buf = MeasurementBuffer(**{
            k: torch.as_tensor(np.asarray(d[f"meas_buf.{k}"]), device=device).to(dt)
            for k, dt in _BUF_DTYPES.items()})
    return TrackerState(arena, t["T_lm_robot"].to(torch.float32),
                        t["velocity"].to(torch.float32), buf)


MODELS = ("stereo", "rgbd")
ESTIMATORS = ("ekf", "weighted_mean", "smoother")


def _check_supported(config: TrackerConfig, model: str) -> None:
    if model not in MODELS:
        raise ValueError(f"tracker model {model!r} is not one of {MODELS}")
    if config.landmark_estimator not in ESTIMATORS:
        raise ValueError(f"landmark estimator {config.landmark_estimator!r} is not "
                         f"one of {ESTIMATORS}")


def _uses_motion_prior(config: TrackerConfig) -> bool:
    return (config.motion_prior_translation_info > 0.0
            or config.motion_prior_rotation_info > 0.0)


def _adapt_to_sensor_points(points, valid, cam: Camera, model: str,
                            min_disparity: float):
    """Measurement rows -> (sensor-frame points, ok, insertion preference):
    stereo prefers higher disparity, RGB-D lower depth."""
    if model == "stereo":
        pts, ok = triangulate_rectified(cam, points, valid, min_disparity)
        return pts, ok, points[:, 0] - points[:, 2]
    pts, ok = unproject(cam, points)
    return pts, ok & valid, -points[:, 2]


@lru_cache(maxsize=16)
def _robot_sensor(T_robot_sensor: tuple, device: torch.device):
    """(T_robot_sensor, its inverse) as 4x4 tensors, made once per device."""
    T_rs = torch.tensor(T_robot_sensor, dtype=torch.float32,
                        device=device).reshape(4, 4)
    return T_rs, se3.inverse(T_rs)


@lru_cache(maxsize=16)
def _prior_weights(translation_info: float, rotation_info: float, device: torch.device):
    """The motion prior's diagonal information [6], made once per device."""
    return torch.tensor([translation_info] * 3 + [rotation_info] * 3,
                        dtype=torch.float32, device=device)


def associate(arena: LandmarkArena, X, meas_points, meas_desc, meas_valid,
              cam: Camera, config: TrackerConfig, r: int, weights_all, idw, mesh=None):
    """One re-association round: project the arena with X and match.

    Returns (matches, stage, pts_moving [N,3], weights [N]) — the GN
    burst's inputs for round ``r``.  On a mesh each rank matches its block
    of the measurement rows against every arena column and the matches are
    all-gathered: the GN rows are every rank's.
    """
    n_stages = len(config.matcher.radius_stages)
    pts_sensor = se3.transform_points(X, arena.pos)
    proj_uv, in_view = project(cam, pts_sensor)
    proj_valid = arena.valid & in_view
    # rounds 0..n-2 force the loose-to-tight schedule; the final round picks
    # the tightest good stage adaptively
    is_final = r == config.rounds - 1
    rows = slice(None)
    if mesh is not None:
        n = meas_points.shape[0] // mesh.size
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    matches, stage = match_projective(
        meas_points[rows, :2], meas_desc[rows], meas_valid[rows], proj_uv, arena.desc,
        proj_valid, config.matcher,
        force_stage=-1 if is_final else max(n_stages - 1 - r, 0), mesh=mesh,
    )
    if mesh is not None:
        matches = type(matches)(*(mesh.all_gather(t, "tracker") for t in matches))
    idx = matches.idx.clamp_min(0).long()
    return matches, stage, arena.pos[idx], weights_all[idx] * idw


def track_step(state: TrackerState, meas_points, meas_desc, meas_valid,
               cam: Camera, config: TrackerConfig, model: str = "stereo", mesh=None):
    """One tracker step on stereo measurements [N, 4] = (uL vL uR vR) or,
    with ``model="rgbd"``, RGB-D measurements [N, 3] = (u v depth_m).

    Returns (new_state, stats, X_final); ``X_final`` maps local-map points
    into the sensor frame.  With ``mesh`` (parallel/spmd.py::slam_step_spmd)
    the inputs are replicated and only the association is sharded, along
    the measurement rows; everything after it runs replicated, with the
    single-device result.
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

    # (uL, vL, uR) | (u, v, d)
    gn_meas = (meas_points[:, :3] if model == "stereo" else meas_points).contiguous()
    weights_all = 1.0 + torch.log1p(arena.num_updates.to(torch.float32))
    if model == "stereo" and config.stereo_inverse_depth_weighting:
        disp = meas_points[:, 0] - meas_points[:, 2]
        mean_disp = torch.where(meas_valid, disp, 0.0).sum() / torch.clamp_min(
            meas_valid.sum(), 1)
        idw = 0.01 + disp / torch.clamp_min(mean_disp, 1e-3)
    else:
        idw = torch.ones((meas_points.shape[0],), dtype=torch.float32, device=dev)

    # the constant-velocity prior: a quadratic pull toward the prediction
    # with unit Jacobian in the left-perturbation parametrisation
    use_prior = _uses_motion_prior(config)

    def with_motion_prior(system):
        if not use_prior:
            return system
        prior_w = _prior_weights(config.motion_prior_translation_info,
                                 config.motion_prior_rotation_info, dev)
        X_pred_inv = se3.inverse(X_pred)

        def wrapped(Xc):
            H, b, st = system(Xc)
            r = se3.log(Xc @ X_pred_inv)
            return H + torch.diag(prior_w), b + prior_w * r, st

        return wrapped

    # the JAX package's use_pallas_gn, less the backend: K2 for the stereo
    # factor without the prior, else the generic loop with no host read
    use_burst = model == "stereo" and not use_prior
    factor = stereo_projective_system if model == "stereo" else projective_depth_system

    # ---- alignment: re-association rounds, one GN burst each ---------------
    for r in range(config.rounds):
        matches, stage, pts_moving, weights = associate(
            arena, X, meas_points, meas_desc, meas_valid, cam, config, r,
            weights_all, idw, mesh)
        if use_burst:
            X, stats = gn_burst_stereo(
                X.contiguous(), pts_moving, gn_meas, weights, matches.mask, cam,
                iterations=config.gn_iterations, damping=config.damping,
                min_inliers=config.min_num_inliers, epsilon=config.gn_epsilon,
                chi_threshold=config.chi_threshold)
        else:
            system = (lambda Xc, pm=pts_moving, w=weights, mk=matches.mask:
                      factor(Xc, pm, gn_meas, w, mk, cam, config.chi_threshold))
            X, stats = gn_iterate(
                with_motion_prior(system), X, config.gn_iterations,
                damping=config.damping, min_inliers=config.min_num_inliers,
                epsilon=config.gn_epsilon, unroll=True)

    # ---- merge: landmark estimator on matched landmarks --------------------
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

    meas_buf = state.meas_buf
    if config.landmark_estimator == "smoother":
        # buffer this frame's observation per landmark, then the
        # structure-only GN over every buffered observation of each
        p_sensor_meas, meas_ok, _ = _adapt_to_sensor_points(
            z_by_lm, matched_lm, cam, model, config.minimum_disparity_px)
        meas_buf = add_measurements(meas_buf, z_by_lm[:, :2], p_sensor_meas, X,
                                    matched_lm & meas_ok)
        sm = smoother_update_batch(arena.pos, meas_buf, arena.num_updates,
                                   arena.valid & matched_lm, cam, config.smoother)
        new_pos, new_cov, accepted = sm.position, arena.cov, sm.accepted
    elif config.landmark_estimator == "weighted_mean":
        p_sensor_meas, meas_ok, _ = _adapt_to_sensor_points(
            z_by_lm, matched_lm, cam, model, config.minimum_disparity_px)
        p_world_meas = se3.transform_points(se3.inverse(X), p_sensor_meas)
        wm = weighted_mean_update_batch(arena.pos, arena.num_updates, p_world_meas,
                                        matched_lm & meas_ok, config.weighted_mean)
        new_pos, new_cov, accepted = wm.position, arena.cov, wm.accepted
    else:
        ekf_out = ekf_update_batch(arena.pos, arena.cov, z_by_lm, matched_lm, X, cam,
                                   "stereo" if model == "stereo" else "projective_depth",
                                   config.ekf)
        new_pos, new_cov, accepted = ekf_out.position, ekf_out.covariance, ekf_out.accepted
    num_merges = accepted.sum()
    arena = arena._replace(
        pos=new_pos,
        cov=new_cov,
        desc=torch.where(matched_lm[:, None], desc_by_lm, arena.desc),
        num_updates=arena.num_updates + accepted.to(torch.int32),
    )

    # ---- merge: ranked binned insertion of unmatched measurements ----------
    pts_sensor_new, tri_ok, pref = _adapt_to_sensor_points(
        meas_points, meas_valid, cam, model, config.minimum_disparity_px)
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
        occupied.index_fill_(0, map_bins, True)
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
        meas_buf=meas_buf,
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
