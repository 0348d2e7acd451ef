#!/usr/bin/env python3
"""Diagnostics of the PyTorch port on the rendered-sequence pipeline, the
twin of scripts/diag_rendered.py (a developer tool).

Part 1: stereo adaptor quality against the exact rendered disparity
        (``sparse_stereo_gt``, the reference's evaluateStereoMatches) at
        frames 0, 60 and 75 of the default loop.
Part 2: per-frame trace of the full SLAM loop: inliers, matcher stage,
        position and yaw error, wall time per stage (each ending in a
        synchronize of the card).

Same flags and printed lines as the JAX script, plus ``--device``
(default ``cuda``).

    python3 scripts/diag_rendered_torch.py [--part 0|1|2] [--frames 130] \\
        [--idw] [--prior INFO] [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srrg2_proslam_tpu_torch.io import synthetic as syn  # noqa: E402
from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.models.slam import (  # noqa: E402
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig  # noqa: E402
from srrg2_proslam_tpu_torch.utils.profiling import sync  # noqa: E402

PART1_FRAMES = (0, 60, 75)


def part1_stereo_quality(n_frames=3, device=torch.device("cuda")):
    """Adaptor quality at PART1_FRAMES -> [(frame, n_feat, inlier share at
    1 px, median error px, p90 error px)] (also printed)."""
    cam = syn.synthetic_camera()
    planes = syn.make_room(size_x=22.0, size_z=32.0, device=device)
    poses = syn.loop_trajectory()
    acfg = StereoAdaptorConfig()
    out = []
    for i in PART1_FRAMES[:n_frames]:
        left, right, depth = syn.render_stereo(cam, torch.as_tensor(poses[i], device=device),
                                               planes)
        meas = adapt_stereo(left, right, acfg)
        pts = meas.points.cpu().numpy()
        ok = meas.valid.cpu().numpy()
        uv = pts[ok, :2]
        disp = pts[ok, 0] - pts[ok, 2]
        gt_disp = syn.sparse_stereo_gt(cam, depth.cpu().numpy(), uv)
        err = np.abs(disp - gt_disp)
        fin = np.isfinite(gt_disp)
        row = (i, int(ok.sum()), float((err[fin] < 1.0).mean()), float(np.median(err[fin])),
               float(np.percentile(err[fin], 90)))
        out.append(row)
        print(f"frame {i}: n_feat={row[1]} inlier@1px={row[2]:.3f} "
              f"median_err={row[3]:.3f}px p90={row[4]:.2f}px")
    return out


def part2_trace(frames, idw=False, prior=0.0, device=torch.device("cuda")):
    """The loop's first ``frames`` frames through GraphSLAM, one row per
    frame (printed where a split, a closure, few inliers or every 5th
    frame) -> (rows, GraphSLAM)."""
    config = GraphSLAMConfig(
        tracker=TrackerConfig(
            stereo_inverse_depth_weighting=idw,
            motion_prior_translation_info=prior,
            motion_prior_rotation_info=prior,
        ),
        splitting=SplittingConfig(maximum_translation_m=5.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=5),
        arena_capacity=4096,
        database_capacity=16384,
        max_db_descriptors_per_map=512,
    )
    cam = syn.synthetic_camera()
    slam = GraphSLAM(cam, config, model="stereo", device=device)
    acfg = StereoAdaptorConfig()
    rows = []
    for n, fr in enumerate(syn.iter_rendered_loop(count=frames, device=device)):
        sync(device)
        t0 = time.perf_counter()
        meas = adapt_stereo(fr.left, fr.right, acfg)
        sync(device)
        t1 = time.perf_counter()
        nmaps0, nclo0 = slam.num_maps, slam.num_closures
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        sync(device)
        t2 = time.perf_counter()
        T = slam.robot_in_world()
        dp = np.linalg.norm(T[:3, 3] - fr.gt_pose[:3, 3])
        Rerr = T[:3, :3].T @ fr.gt_pose[:3, :3]
        ang = np.degrees(np.arccos(np.clip((np.trace(Rerr) - 1) / 2, -1, 1)))
        s = slam.last_stats
        rows.append((n, float(t1 - t0), float(t2 - t1),
                     int(s.num_inliers), int(s.num_matches),
                     int(s.matcher_stage), dp, ang,
                     slam.num_maps - nmaps0, slam.num_closures - nclo0,
                     slam.status))
    print(f"\n{'n':>4} {'adapt_ms':>8} {'track_ms':>8} {'inl':>5} {'mat':>5} "
          f"{'stg':>3} {'pos_err':>8} {'yaw_err':>8} split clo status")
    for r in rows:
        if r[0] % 5 == 0 or r[8] or r[9] or r[3] < 20:
            print(f"{r[0]:>4} {r[1]*1e3:>8.1f} {r[2]*1e3:>8.1f} {r[3]:>5} "
                  f"{r[4]:>5} {r[5]:>3} {r[6]:>8.3f} {r[7]:>8.3f} "
                  f"{r[8]:>5} {r[9]:>3} {r[10]}")
    tt = np.array([r[2] for r in rows[5:]])
    ta = np.array([r[1] for r in rows[5:]])
    if len(tt):
        print(f"\nsteady-state: adapt med={np.median(ta)*1e3:.1f}ms "
              f"p90={np.percentile(ta,90)*1e3:.1f}ms | track "
              f"med={np.median(tt)*1e3:.1f}ms p90={np.percentile(tt,90)*1e3:.1f}ms "
              f"max={tt.max()*1e3:.1f}ms")
    print(f"maps={slam.num_maps} closures={slam.num_closures} "
          f"reloc={slam.num_relocalizations}")
    return rows, slam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", type=int, default=0)
    ap.add_argument("--frames", type=int, default=130)
    ap.add_argument("--idw", action="store_true")
    ap.add_argument("--prior", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.part in (0, 1):
        part1_stereo_quality(device=device)
    if args.part in (0, 2):
        part2_trace(args.frames, idw=args.idw, prior=args.prior, device=device)


if __name__ == "__main__":
    main()
