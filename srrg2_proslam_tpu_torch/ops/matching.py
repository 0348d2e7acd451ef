"""Descriptor matching: epipolar stereo and projective.

Port of srrg2_proslam_tpu/ops/matching.py.  Every matcher is one masked
Hamming cost matrix reduced by mutual-argmin plus Lowe's ratio test;
matchers return per-row target indices with a validity mask.  Argmin ties
take the first index, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .hamming import distance_matrix

_BIG = 1e9


@dataclass(frozen=True)
class EpipolarMatcherConfig:
    epipolar_thickness_px: float = 1.0
    maximum_descriptor_distance: float = 100.0
    maximum_disparity_px: float = 100.0
    minimum_disparity_px: float = 0.0
    lowe_ratio: float = 0.5
    minimum_matching_ratio: float = 0.3


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

    idx: torch.Tensor       # [N_a] int32 index into B, -1 if unmatched
    distance: torch.Tensor  # [N_a] float32 descriptor distance (BIG if unmatched)
    mask: torch.Tensor      # [N_a] bool

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum()


def _min2(masked_cost: torch.Tensor):
    """Row-wise (best, second-best, argmin) of a [N, M] masked cost matrix."""
    best_idx = torch.argmin(masked_cost, dim=1)
    d1 = masked_cost.amin(dim=1)
    without_best = masked_cost.scatter(1, best_idx[:, None], _BIG)
    d2 = without_best.amin(dim=1)
    return d1, d2, best_idx


def match_cost_matrix(cost: torch.Tensor, feasible: torch.Tensor,
                      max_distance: float, lowe_ratio: float) -> Matches:
    """Bijective mutual-best matching with Lowe's ratio test."""
    masked = torch.where(feasible, cost, _BIG)
    d1, d2, best_b = _min2(masked)
    col_best_a = torch.argmin(masked, dim=0)
    rows = torch.arange(cost.shape[0], device=cost.device)
    mutual = col_best_a[best_b] == rows
    lowe_ok = d1 <= lowe_ratio * d2
    ok = (d1 <= max_distance) & lowe_ok & mutual
    return Matches(
        idx=torch.where(ok, best_b, -1).to(torch.int32),
        distance=torch.where(ok, d1, _BIG),
        mask=ok,
    )


def match_epipolar(uv_left, desc_left, valid_left, uv_right, desc_right,
                   valid_right, config: EpipolarMatcherConfig) -> Matches:
    """Rectified stereo matching: row band and disparity range gate the
    Hamming matrix."""
    cost = distance_matrix(desc_left, desc_right).to(torch.float32)
    dv = (uv_left[:, None, 1] - uv_right[None, :, 1]).abs()
    disparity = uv_left[:, None, 0] - uv_right[None, :, 0]
    feasible = (
        valid_left[:, None]
        & valid_right[None, :]
        & (dv <= config.epipolar_thickness_px)
        & (disparity >= config.minimum_disparity_px)
        & (disparity <= config.maximum_disparity_px)
    )
    return match_cost_matrix(cost, feasible, config.maximum_descriptor_distance,
                             config.lowe_ratio)


def _geometric_distance(delta: torch.Tensor, norm: str) -> torch.Tensor:
    if norm == "square":
        return delta.abs().amax(dim=-1)
    if norm == "rhombus":
        return delta.abs().sum(dim=-1)
    return torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)


def match_projective(meas_uv, meas_desc, meas_valid, proj_uv, proj_desc,
                     proj_valid, config: ProjectiveMatcherConfig,
                     force_stage: int = -1):
    """Frame-to-map matcher over a staged radius/descriptor schedule.

    Returns (Matches over measurement rows with idx into map points, stage).
    ``force_stage >= 0`` pins the stage; otherwise the tightest stage whose
    matching ratio reaches ``minimum_matching_ratio`` wins (the loosest if
    none does).
    """
    cost = distance_matrix(meas_desc, proj_desc).to(torch.float32)
    delta = meas_uv[:, None, :] - proj_uv[None, :, :]
    geo = _geometric_distance(delta, config.norm)
    base_valid = meas_valid[:, None] & proj_valid[None, :]
    device = cost.device

    n_stages = len(config.radius_stages)
    if force_stage >= 0:
        s = min(force_stage, n_stages - 1)
        feasible = base_valid & (geo <= config.radius_stages[s])
        m = match_cost_matrix(cost, feasible, config.descriptor_stages[s],
                              config.lowe_ratio)
        return m, torch.full((), s, dtype=torch.int32, device=device)

    per_stage = []
    for s in range(n_stages):
        feasible = base_valid & (geo <= config.radius_stages[s])
        per_stage.append(match_cost_matrix(
            cost, feasible, config.descriptor_stages[s], config.lowe_ratio))
    num_meas = torch.clamp_min(meas_valid.sum(), 1)
    counts = torch.stack([m.count for m in per_stage])
    ratios = counts.to(torch.float32) / num_meas.to(torch.float32)
    good = ratios >= config.minimum_matching_ratio
    stage = torch.where(good.any(), torch.argmax(good.to(torch.int32)),
                        n_stages - 1).to(torch.int32)
    sel = stage.long()
    idx = torch.stack([m.idx for m in per_stage])[sel]
    distance = torch.stack([m.distance for m in per_stage])[sel]
    mask = torch.stack([m.mask for m in per_stage])[sel]
    return Matches(idx=idx, distance=distance, mask=mask), stage
