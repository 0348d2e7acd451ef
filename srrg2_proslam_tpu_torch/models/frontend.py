"""Stereo measurement adaptor: raw image pair -> fixed-capacity 4-D points.

Port of srrg2_proslam_tpu/models/frontend.py (stereo path): extract left
and right features as one batch, match along epipolar lines, and emit
[uL vL uR vR] rows carrying the left descriptor, with disparities below the
minimum dropped.
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


@dataclass(frozen=True)
class StereoAdaptorConfig:
    extractor: FeatureExtractorConfig = field(default_factory=FeatureExtractorConfig)
    matcher: EpipolarMatcherConfig = field(default_factory=EpipolarMatcherConfig)
    minimum_disparity_px: float = 1.0
    # SSD-parabola disparity refinement (ops/subpixel.py), not ported yet
    subpixel_refinement: bool = False


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
