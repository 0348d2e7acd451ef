"""Measurement adaptors: raw images -> fixed-capacity measurements.

Port of srrg2_proslam_tpu/models/frontend.py, per frame:

  * stereo: extract left and right features as one batch, match along
    epipolar lines, and emit [uL vL uR vR] rows carrying the left
    descriptor, with disparities below the minimum dropped;
  * RGB-D: extract features on the intensity image (a batch of one), look
    up each keypoint's raw depth, scale it to metres and emit [u v depth]
    rows, depths outside the configured range dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..ops.features import FeatureExtractorConfig, extract_features_batch
from ..ops.matching import EpipolarMatcherConfig, match_epipolar


class StereoMeasurement(NamedTuple):
    """points[N, 4] = (uL, vL, uR, vR); desc is the left descriptor."""

    points: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum()


class DepthMeasurement(NamedTuple):
    """points[N, 3] = (u, v, depth_m)."""

    points: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum()


@dataclass(frozen=True)
class StereoAdaptorConfig:
    extractor: FeatureExtractorConfig = field(default_factory=FeatureExtractorConfig)
    matcher: EpipolarMatcherConfig = field(default_factory=EpipolarMatcherConfig)
    minimum_disparity_px: float = 1.0
    # SSD-parabola disparity refinement (ops/subpixel.py), not ported yet
    subpixel_refinement: bool = False


@dataclass(frozen=True)
class DepthAdaptorConfig:
    extractor: FeatureExtractorConfig = field(default_factory=FeatureExtractorConfig)
    # raw depth units -> metres (the bundled ICL PGMs are millimetres)
    depth_scale: float = 1.0e-3
    minimum_depth_m: float = 0.1
    maximum_depth_m: float = 50.0


def _stereo_tail(image_left, image_right, uv_l, desc_l, valid_l, uv_r, desc_r,
                 valid_r, config: StereoAdaptorConfig) -> StereoMeasurement:
    """Epipolar matching and measurement assembly for one pair."""
    if config.subpixel_refinement:
        raise NotImplementedError("subpixel_refinement is not ported yet")
    matches = match_epipolar(uv_l, desc_l, valid_l, uv_r, desc_r, valid_r,
                             config.matcher)
    uv_r_matched = uv_r[matches.idx.clamp_min(0).long()]
    u_r = uv_r_matched[:, 0]
    disparity = uv_l[:, 0] - u_r
    ok = matches.mask & (disparity >= config.minimum_disparity_px)
    # v = epipolar row mean, consistent with the rectified projection model
    v_mean = 0.5 * (uv_l[:, 1] + uv_r_matched[:, 1])
    points = torch.stack([uv_l[:, 0], v_mean, u_r, v_mean], dim=-1)
    return StereoMeasurement(
        points=torch.where(ok[:, None], points, 0.0),
        desc=torch.where(ok[:, None], desc_l, -1).to(torch.int8),
        valid=ok,
    )


def adapt_stereo(image_left: torch.Tensor, image_right: torch.Tensor,
                 config: StereoAdaptorConfig) -> StereoMeasurement:
    """Stereo frame -> 4-D measurements.  Images: [H, W] float32 (0..255)."""
    images = torch.stack([image_left, image_right])
    feats = extract_features_batch(images, config.extractor)
    return _stereo_tail(
        image_left, image_right,
        feats.uv[0], feats.desc[0], feats.valid[0],
        feats.uv[1], feats.desc[1], feats.valid[1], config,
    )


def _rgbd_tail(uv, desc, valid, depth_raw, config: DepthAdaptorConfig) -> DepthMeasurement:
    """Per-keypoint depth lookup and measurement assembly for one frame."""
    H, W = depth_raw.shape
    y = uv[:, 1].to(torch.int32).clamp(0, H - 1).long()
    x = uv[:, 0].to(torch.int32).clamp(0, W - 1).long()
    depth = depth_raw[y, x] * config.depth_scale
    ok = valid & (depth > config.minimum_depth_m) & (depth < config.maximum_depth_m)
    points = torch.cat([uv, depth[:, None]], dim=-1)
    return DepthMeasurement(
        points=torch.where(ok[:, None], points, 0.0),
        desc=torch.where(ok[:, None], desc, -1).to(torch.int8),
        valid=ok,
    )


def adapt_rgbd(intensity: torch.Tensor, depth_raw: torch.Tensor,
               config: DepthAdaptorConfig) -> DepthMeasurement:
    """RGB-D frame -> 3-D (u, v, depth_m) measurements.  intensity [H, W]
    float32 (0..255); depth_raw [H, W] float32 raw units (scaled by
    ``depth_scale``)."""
    feats = extract_features_batch(intensity[None], config.extractor)
    return _rgbd_tail(feats.uv[0], feats.desc[0], feats.valid[0], depth_raw, config)
