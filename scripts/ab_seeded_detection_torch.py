#!/usr/bin/env python3
"""A/B of the PyTorch port: dense against seeded (stripe-masked)
right-camera detection, the twin of scripts/ab_seeded_detection.py.

Measures whether dense detection subsumes the reference's seeded /
selective extractor on the rendered sequence (60 frames of the 8 x 6 m
loop at 320x416), a low-texture (contrast-crushed) stretch included:

  * stereo matches per frame and their recall at 1 px against the exact
    rendered disparities (the reference's ground-truth method);
  * short-horizon VO tracking inliers per frame with each variant's
    measurements.

Same printed table as the JAX script, plus ``--device`` (default
``cuda``).  The JAX script jit-compiles ``adapt_variant``; here it is a
plain call.

    python3 scripts/ab_seeded_detection_torch.py [--device cuda|cpu]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srrg2_proslam_tpu_torch.io import synthetic as syn  # noqa: E402
from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.models.tracker import (  # noqa: E402
    TrackerConfig, initial_state, track_step,
)
from srrg2_proslam_tpu_torch.ops import features as F  # noqa: E402
from srrg2_proslam_tpu_torch.ops.matching import match_epipolar  # noqa: E402
from srrg2_proslam_tpu_torch.ops.subpixel import refine_disparity  # noqa: E402

FRAMES = 60
CRUSHED = range(24, 30)   # low-texture stretch: 85% contrast crush


def adapt_variant(left, right, acfg, seeded: bool):
    """adapt_stereo with optional seeded right-camera detection ->
    (points, desc, valid, left features, disparity)."""
    feats_l = F.extract_features(left, acfg.extractor)
    mask = None
    if seeded:
        mask = F.stripe_mask(right.shape[0], right.shape[1], feats_l.uv[:, 1], feats_l.valid,
                             thickness=acfg.matcher.epipolar_thickness_px)
    feats_r = F.extract_features(right, acfg.extractor, mask)
    m = match_epipolar(feats_l.uv, feats_l.desc, feats_l.valid,
                       feats_r.uv, feats_r.desc, feats_r.valid, acfg.matcher)
    idx = torch.clamp_min(m.idx, 0).long()
    uv_r = feats_r.uv[idx]
    u_r = refine_disparity(left, right, feats_l.uv, uv_r)
    disparity = feats_l.uv[:, 0] - u_r
    ok = m.mask & (disparity >= acfg.minimum_disparity_px)
    v = 0.5 * (feats_l.uv[:, 1] + uv_r[:, 1])
    points = torch.stack([feats_l.uv[:, 0], v, u_r, v], dim=-1)
    return (torch.where(ok[:, None], points, 0.0),
            torch.where(ok[:, None], feats_l.desc, torch.tensor(-1, dtype=torch.int8,
                                                               device=left.device)),
            ok, feats_l, disparity)


def run(device=torch.device("cuda")):
    """Both variants over the 60 frames -> {seeded: {matches, correct,
    inliers, frames}} (sums over the frames)."""
    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    planes = syn.make_room(size_x=18.0, size_z=26.0, device=device)
    poses = syn.loop_trajectory(side_a=8.0, side_b=6.0, step_m=0.4, turn_frames=8)[:FRAMES]
    acfg = StereoAdaptorConfig()
    tcfg = TrackerConfig()

    stats = {s: dict(matches=0, correct=0, inliers=0, frames=0) for s in (False, True)}
    states = {s: initial_state(4096, device=device) for s in (False, True)}
    for i, T_wc in enumerate(poses):
        left, right, depth = syn.render_stereo(cam, torch.as_tensor(T_wc, device=device),
                                               planes)
        if i in CRUSHED:
            left = syn.crush_exposure(left, 0.85)
            right = syn.crush_exposure(right, 0.85)
        depth_np = depth.cpu().numpy()
        for seeded in (False, True):
            pts, desc, ok, feats_l, disp = adapt_variant(left, right, acfg, seeded)
            pts_np, ok_np, disp_np = pts.cpu().numpy(), ok.cpu().numpy(), disp.cpu().numpy()
            # ground-truth disparity at the matched left keypoints
            u = np.clip(pts_np[:, 0].astype(int), 0, cam.cols - 1)
            v = np.clip(pts_np[:, 1].astype(int), 0, cam.rows - 1)
            z = depth_np[v, u]
            gt_disp = cam.baseline_px / np.maximum(z, 1e-3)
            correct = ok_np & np.isfinite(z) & (np.abs(disp_np - gt_disp) <= 1.0)
            stats[seeded]["matches"] += int(ok_np.sum())
            stats[seeded]["correct"] += int(correct.sum())
            st, ts, _ = track_step(states[seeded], pts, desc, ok, cam, tcfg, "stereo")
            states[seeded] = st
            stats[seeded]["inliers"] += int(ts.num_inliers)
            stats[seeded]["frames"] += 1
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    stats = run(torch.device(ap.parse_args(argv).device))
    print(f"{'variant':10s} {'stereo matches':>16s} {'1px-recall':>12s} "
          f"{'VO inliers/frame':>18s}")
    for seeded in (False, True):
        s = stats[seeded]
        name = "seeded" if seeded else "dense"
        prec = s["correct"] / max(s["matches"], 1)
        print(f"{name:10s} {s['matches'] / s['frames']:16.1f} "
              f"{prec:12.3f} {s['inliers'] / s['frames']:18.1f}")
    return stats


if __name__ == "__main__":
    main()
