"""Measurement adaptors: raw images -> fixed-capacity measurements.

Port of srrg2_proslam_tpu/models/frontend.py:

  * stereo: extract left and right features as one batch, match along
    epipolar lines, optionally refine u_R to sub-pixel (ops/subpixel.py),
    and emit [uL vL uR vR] rows carrying the left descriptor, with
    disparities below the minimum dropped;
  * RGB-D: extract features on the intensity image, look up each
    keypoint's raw depth, scale it to metres and emit [u v depth] rows,
    depths outside the configured range dropped.

``adapt_stereo_batch`` and ``adapt_rgbd_batch`` do the same for B frames
at once: all images go through one ``extract_features_batch`` (one K3 and
one K1 launch on the card), the matching and refinement are batched, and
each frame's result equals the per-frame adaptor's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..ops.features import FeatureExtractorConfig, extract_features_batch
from ..ops.matching import EpipolarMatcherConfig, match_epipolar
from ..ops.subpixel import refine_disparity_batch
from ..utils import config as cfg


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


@cfg.register
@dataclass(frozen=True)
class StereoAdaptorConfig:
    extractor: FeatureExtractorConfig = field(default_factory=FeatureExtractorConfig)
    matcher: EpipolarMatcherConfig = field(default_factory=EpipolarMatcherConfig)
    minimum_disparity_px: float = 1.0
    # SSD-parabola disparity refinement (ops/subpixel.py)
    subpixel_refinement: bool = False


@cfg.register
@dataclass(frozen=True)
class DepthAdaptorConfig:
    extractor: FeatureExtractorConfig = field(default_factory=FeatureExtractorConfig)
    # raw depth units -> metres (the bundled ICL PGMs are millimetres)
    depth_scale: float = 1.0e-3
    minimum_depth_m: float = 0.1
    maximum_depth_m: float = 50.0


def _stereo_tail(lefts, rights, feats, config: StereoAdaptorConfig) -> StereoMeasurement:
    """Epipolar matching, sub-pixel refinement and measurement assembly for
    B pairs: ``feats`` holds the B left images' features, then the B right
    images'.  Returns measurements with leading axis B."""
    B = lefts.shape[0]
    uv_l, desc_l, valid_l = feats.uv[:B], feats.desc[:B], feats.valid[:B]
    uv_r_all = feats.uv[B:]
    matches = match_epipolar(uv_l, desc_l, valid_l, uv_r_all, feats.desc[B:],
                             feats.valid[B:], config.matcher)
    idx = matches.idx.clamp_min(0).long()
    uv_r = torch.gather(uv_r_all, 1, idx[..., None].expand(-1, -1, 2))
    u_r = uv_r[..., 0]
    if config.subpixel_refinement:
        u_r = refine_disparity_batch(lefts, rights, uv_l, uv_r)
    disparity = uv_l[..., 0] - u_r
    ok = matches.mask & (disparity >= config.minimum_disparity_px)
    # v = epipolar row mean, consistent with the rectified projection model
    v_mean = 0.5 * (uv_l[..., 1] + uv_r[..., 1])
    points = torch.stack([uv_l[..., 0], v_mean, u_r, v_mean], dim=-1)
    return StereoMeasurement(
        points=torch.where(ok[..., None], points, 0.0),
        desc=torch.where(ok[..., None], desc_l, -1).to(torch.int8),
        valid=ok,
    )


def adapt_stereo_batch(lefts: torch.Tensor, rights: torch.Tensor,
                       config: StereoAdaptorConfig) -> StereoMeasurement:
    """B stereo frames -> 4-D measurements with leading axis B.  Images:
    [B, H, W] float32 (0..255), all 2B through one batched frontend."""
    feats = extract_features_batch(torch.cat([lefts, rights]), config.extractor)
    return _stereo_tail(lefts, rights, feats, config)


def adapt_stereo(image_left: torch.Tensor, image_right: torch.Tensor,
                 config: StereoAdaptorConfig) -> StereoMeasurement:
    """Stereo frame -> 4-D measurements.  Images: [H, W] float32 (0..255)."""
    meas = adapt_stereo_batch(image_left[None], image_right[None], config)
    return StereoMeasurement(*(t[0] for t in meas))


def _rgbd_tail(uv, desc, valid, depth_raw, config: DepthAdaptorConfig) -> DepthMeasurement:
    """Per-keypoint depth lookup and measurement assembly for B frames:
    uv [B, N, 2], depth_raw [B, H, W]."""
    B, H, W = depth_raw.shape
    y = uv[..., 1].to(torch.int32).clamp(0, H - 1).long()
    x = uv[..., 0].to(torch.int32).clamp(0, W - 1).long()
    depth = torch.gather(depth_raw.reshape(B, H * W), 1, y * W + x) * config.depth_scale
    ok = valid & (depth > config.minimum_depth_m) & (depth < config.maximum_depth_m)
    points = torch.cat([uv, depth[..., None]], dim=-1)
    return DepthMeasurement(
        points=torch.where(ok[..., None], points, 0.0),
        desc=torch.where(ok[..., None], desc, -1).to(torch.int8),
        valid=ok,
    )


def adapt_rgbd_batch(intensities: torch.Tensor, depths_raw: torch.Tensor,
                     config: DepthAdaptorConfig) -> DepthMeasurement:
    """B RGB-D frames -> measurements with leading axis B.  intensities [B,
    H, W] float32 (0..255), through one batched frontend; depths_raw [B, H,
    W] float32 raw units."""
    feats = extract_features_batch(intensities, config.extractor)
    return _rgbd_tail(feats.uv, feats.desc, feats.valid, depths_raw, config)


def adapt_rgbd(intensity: torch.Tensor, depth_raw: torch.Tensor,
               config: DepthAdaptorConfig) -> DepthMeasurement:
    """RGB-D frame -> 3-D (u, v, depth_m) measurements.  intensity [H, W]
    float32 (0..255); depth_raw [H, W] float32 raw units (scaled by
    ``depth_scale``)."""
    meas = adapt_rgbd_batch(intensity[None], depth_raw[None], config)
    return DepthMeasurement(*(t[0] for t in meas))
