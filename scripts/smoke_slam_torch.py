#!/usr/bin/env python3
"""Smoke test of the PyTorch port: GraphSLAM (local maps and splitting) on
the bundled KITTI city frames, the twin of scripts/smoke_slam.py.

Forces a small splitting threshold (1.5 m) so the 5 frames exercise
local-map creation, graph edges and trajectory unrolling, and checks the
same reference integration bound as smoke_vo (tests/test_trackers.cpp:
327-365).  Same printed lines and verdict as the JAX script, plus
``--device`` (default ``cuda``).

    python3 scripts/smoke_slam_torch.py [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo  # noqa: E402
from srrg2_proslam_tpu_torch.models.slam import (  # noqa: E402
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_tpu_torch.ops import se3  # noqa: E402

GATE_T = np.array([0.2, 0.2, 0.7])   # m
GATE_ANGLE = 0.01                     # rad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)

    frames = list(datasets.iter_bundled_kitti(os.path.join(ROOT, "test_data"), "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    acfg = StereoAdaptorConfig()
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=1.5),
        enable_loop_closing=True,
    )
    slam = GraphSLAM(cam, config, device=device)

    t0 = time.time()
    for i, fr in enumerate(frames):
        meas = adapt_stereo(torch.as_tensor(fr.left, device=device),
                            torch.as_tensor(fr.right, device=device), acfg)
        stats = slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        T = slam.robot_in_world()
        print(
            f"frame {i}: status={slam.status} maps={slam.num_maps} "
            f"edges={slam.num_edges} inliers={int(stats.num_inliers)} "
            f"t={T[:3,3].round(3)}"
        )
    dt = time.time() - t0
    print(f"wall: {dt:.2f}s  local maps: {slam.num_maps}  closures: {slam.num_closures}")

    traj = slam.trajectory()
    gt_final = frames[-1].gt_pose
    t_err, angle = se3.error_t_and_angle(torch.as_tensor(traj[-1].astype(np.float32)),
                                         torch.as_tensor(gt_final))
    print("per-axis |t err|:", t_err.numpy().round(4), "angle:", float(angle))
    ok = np.all(t_err.numpy() <= GATE_T) and float(angle) <= GATE_ANGLE
    print("PASS" if ok else "FAIL")


if __name__ == "__main__":
    main()
