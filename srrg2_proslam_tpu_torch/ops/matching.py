"""Descriptor matching: brute force, epipolar stereo and projective.

Port of srrg2_proslam_tpu/ops/matching.py.  Every matcher is one masked
Hamming cost matrix reduced by mutual-argmin plus Lowe's ratio test;
matchers return per-row target indices with a validity mask.  Argmin ties
take the first index, as in JAX.  The brute-force and epipolar matchers
also take a leading batch dimension (one cost matrix per frame); each
frame's result does not depend on the batch.

The projective matcher also runs on a mesh (parallel/spmd.py): each rank
holds a block of the measurement rows against every map column; the
column-side argmin over all rows is one MIN all-reduce of packed keys
(distance * rows + global row: ties to the lowest row, as argmin) and the
adaptive stage's counts one SUM, so each row's match equals the
single-device one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils import config as cfg
from .hamming import distance_matrix

_BIG = 1e9


@cfg.register
@dataclass(frozen=True)
class BruteforceMatcherConfig:
    maximum_descriptor_distance: float = 50.0
    lowe_ratio: float = 0.5
    minimum_matching_ratio: float = 0.25


@cfg.register
@dataclass(frozen=True)
class EpipolarMatcherConfig:
    epipolar_thickness_px: float = 1.0
    maximum_descriptor_distance: float = 100.0
    maximum_disparity_px: float = 100.0
    minimum_disparity_px: float = 0.0
    lowe_ratio: float = 0.5
    minimum_matching_ratio: float = 0.3


@cfg.register
@dataclass(frozen=True)
class ProjectiveMatcherConfig:
    """Staged schedule: stage i uses (radius_stages[i], descriptor_stages[i]);
    a wide radius pairs with a strict descriptor threshold."""

    radius_stages: tuple = (10.0, 25.0, 90.0)
    descriptor_stages: tuple = (75.0, 50.0, 25.0)
    lowe_ratio: float = 0.8
    minimum_matching_ratio: float = 0.1
    norm: str = "circle"  # "circle" (L2) | "square" (Linf) | "rhombus" (L1)


class Matches(NamedTuple):
    """Row-aligned match set: for each element of set A, a target in set B."""

    idx: torch.Tensor       # [..., N_a] int32 index into B, -1 if unmatched
    distance: torch.Tensor  # [..., N_a] float32 descriptor distance (BIG if unmatched)
    mask: torch.Tensor      # [..., N_a] bool

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)


def _min2(masked_cost: torch.Tensor):
    """Row-wise (best, second-best, argmin) of a [..., N, M] masked cost
    matrix.  It overwrites each row's best entry of ``masked_cost`` with _BIG."""
    best_idx = torch.argmin(masked_cost, dim=-1)
    d1 = torch.gather(masked_cost, -1, best_idx[..., None])[..., 0]   # the row minimum
    d2 = masked_cost.scatter_(-1, best_idx[..., None], _BIG).amin(dim=-1)
    return d1, d2, best_idx


def match_cost_matrix(cost: torch.Tensor, feasible: torch.Tensor,
                      max_distance: float, lowe_ratio: float, mesh=None) -> Matches:
    """Bijective mutual-best matching with Lowe's ratio test on [..., N, M];
    on a mesh [N, M] is the rank's block of N * size rows."""
    masked = torch.where(feasible, cost, _BIG)
    rows = torch.arange(cost.shape[-2], device=cost.device)
    if mesh is None:
        col_best_a = torch.argmin(masked, dim=-2)
    else:
        # integer distances (or _BIG, exact in float32) packed with the row
        n_rows = cost.shape[-2] * mesh.size
        rows = rows + mesh.rank * cost.shape[-2]
        key = masked.to(torch.int64) * n_rows + rows[:, None]
        col_best_a = mesh.all_min(key.amin(dim=-2), "tracker") % n_rows
    d1, d2, best_b = _min2(masked)     # ``masked`` is ours to overwrite
    mutual = torch.gather(col_best_a, -1, best_b) == rows
    lowe_ok = d1 <= lowe_ratio * d2
    ok = (d1 <= max_distance) & lowe_ok & mutual
    return Matches(
        idx=torch.where(ok, best_b, -1).to(torch.int32),
        distance=torch.where(ok, d1, _BIG),
        mask=ok,
    )


def match_bruteforce(desc_a, valid_a, desc_b, valid_b,
                     config: BruteforceMatcherConfig) -> Matches:
    """Exhaustive descriptor matching ([..., N, 256] against [..., M, 256])."""
    cost = distance_matrix(desc_a, desc_b).to(torch.float32)
    feasible = valid_a[..., :, None] & valid_b[..., None, :]
    return match_cost_matrix(cost, feasible, config.maximum_descriptor_distance,
                             config.lowe_ratio)


def match_epipolar(uv_left, desc_left, valid_left, uv_right, desc_right,
                   valid_right, config: EpipolarMatcherConfig) -> Matches:
    """Rectified stereo matching: row band and disparity range gate the
    Hamming matrix (one pair, or a batch of pairs with a leading dim)."""
    cost = distance_matrix(desc_left, desc_right).to(torch.float32)
    dv = (uv_left[..., :, None, 1] - uv_right[..., None, :, 1]).abs()
    disparity = uv_left[..., :, None, 0] - uv_right[..., None, :, 0]
    feasible = (
        valid_left[..., :, None]
        & valid_right[..., None, :]
        & (dv <= config.epipolar_thickness_px)
        & (disparity >= config.minimum_disparity_px)
        & (disparity <= config.maximum_disparity_px)
    )
    return match_cost_matrix(cost, feasible, config.maximum_descriptor_distance,
                             config.lowe_ratio)


def _geometric_distance(dx: torch.Tensor, dy: torch.Tensor, norm: str) -> torch.Tensor:
    """The search region's distance of pixel offsets (dx, dy)."""
    if norm == "square":
        return torch.maximum(dx.abs(), dy.abs())
    if norm == "rhombus":
        return dx.abs() + dy.abs()
    return torch.sqrt(dx * dx + dy * dy + 1e-12)


def match_projective(meas_uv, meas_desc, meas_valid, proj_uv, proj_desc,
                     proj_valid, config: ProjectiveMatcherConfig,
                     force_stage: int = -1, mesh=None):
    """Frame-to-map matcher over a staged radius/descriptor schedule.

    Returns (Matches over measurement rows with idx into map points, stage).
    ``force_stage >= 0`` pins the stage; otherwise the tightest stage whose
    matching ratio reaches ``minimum_matching_ratio`` wins (the loosest if
    none does).  On a mesh the measurement rows are the rank's block.

    On the host (CPU tensors, no mesh) only the valid rows and columns enter
    the matrices.  A row or column that is not valid is infeasible at every
    stage, and taking the others in their order keeps argmin's ties, so
    every row's match and the stage are the whole matrices' to the bit.
    """
    if mesh is None and meas_uv.device.type == "cpu":
        rows, cols = meas_valid.nonzero()[:, 0], proj_valid.nonzero()[:, 0]
        if rows.numel() and cols.numel():
            m, stage = _match_projective(meas_uv[rows], meas_desc[rows], meas_valid[rows],
                                         proj_uv[cols], proj_desc[cols], proj_valid[cols],
                                         config, force_stage)
            n = meas_uv.shape[0]
            idx = torch.full((n,), -1, dtype=torch.int32)
            idx[rows] = torch.where(m.mask, cols[m.idx.clamp_min(0).long()].to(torch.int32), -1)
            distance = torch.full((n,), _BIG, dtype=m.distance.dtype)
            distance[rows] = m.distance
            mask = torch.zeros(n, dtype=torch.bool)
            mask[rows] = m.mask
            return Matches(idx=idx, distance=distance, mask=mask), stage
    return _match_projective(meas_uv, meas_desc, meas_valid, proj_uv, proj_desc, proj_valid,
                             config, force_stage, mesh)


def _match_projective(meas_uv, meas_desc, meas_valid, proj_uv, proj_desc, proj_valid,
                      config: ProjectiveMatcherConfig, force_stage: int = -1, mesh=None):
    """match_projective over the whole matrices."""
    cost = distance_matrix(meas_desc, proj_desc).to(torch.float32)
    geo = _geometric_distance(meas_uv[:, None, 0] - proj_uv[None, :, 0],
                              meas_uv[:, None, 1] - proj_uv[None, :, 1], config.norm)
    base_valid = meas_valid[:, None] & proj_valid[None, :]
    device = cost.device

    n_stages = len(config.radius_stages)
    if force_stage >= 0:
        s = min(force_stage, n_stages - 1)
        feasible = base_valid & (geo <= config.radius_stages[s])
        m = match_cost_matrix(cost, feasible, config.descriptor_stages[s],
                              config.lowe_ratio, mesh)
        return m, torch.full((), s, dtype=torch.int32, device=device)

    per_stage = []
    for s in range(n_stages):
        feasible = base_valid & (geo <= config.radius_stages[s])
        per_stage.append(match_cost_matrix(
            cost, feasible, config.descriptor_stages[s], config.lowe_ratio, mesh))
    num_meas = meas_valid.sum()
    counts = torch.stack([m.count for m in per_stage])
    if mesh is not None:
        num_meas, counts = mesh.all_sum(torch.cat([num_meas[None], counts]), "tracker").split(
            [1, n_stages])
        num_meas = num_meas[0]
    num_meas = torch.clamp_min(num_meas, 1)
    ratios = counts.to(torch.float32) / num_meas.to(torch.float32)
    good = ratios >= config.minimum_matching_ratio
    stage = torch.where(good.any(), torch.argmax(good.to(torch.int32)),
                        n_stages - 1).to(torch.int32)
    # index_select: indexing by a 0-dim tensor reads it back to the host
    sel = stage.long().reshape(1)
    idx, distance, mask = (torch.stack([getattr(m, f) for m in per_stage])
                           .index_select(0, sel)[0] for f in ("idx", "distance", "mask"))
    return Matches(idx=idx, distance=distance, mask=mask), stage
