"""Configs of the non-EKF landmark estimators.

Only the dataclasses are ported so far (``TrackerConfig`` carries them);
the weighted-mean and pose-based-smoother updates of
srrg2_proslam_tpu/ops/landmark_estimators.py are later work, and the
tracker raises NotImplementedError when one is selected.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WeightedMeanConfig:
    maximum_distance_geometry_m2: float = 25.0


@dataclass(frozen=True)
class SmootherConfig:
    maximum_reprojection_error_px2: float = 100.0
    minimum_measurements: int = 3
    iterations: int = 10
    depth_weight: float = 10.0
    maximum_distance_geometry_m2: float = 25.0
